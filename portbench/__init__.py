"""The benchmark of the PyTorch and CUDA port (``reptext_tpu_torch``): see README.md."""
