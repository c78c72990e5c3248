"""reptext-tpu's PyTorch + CUDA port, for NVIDIA Hopper (H100).

A second package beside the JAX reference ``reptext_tpu``, with the same
sub-package names:

- ``ops``: latents, RoPE, the attention entry point, and the hand-written
  CUDA flash-attention kernels, forward (``csrc/flash_attention.cu``: K1,
  K2, the streaming K3, the attention study's three variants and K5's ring
  step) and backward (``csrc/flash_attention_bwd.cu``), with their build
  (``ops/_build.py``), autograd wiring and plain PyTorch twins;
- ``nn``: layers, embeddings, MMDiT blocks, VAE, CLIP and T5 encoders;
- ``models``: the FLUX transformer and the RepText ControlNet (with remat and
  the warm-start weight surgery);
- ``sampling``: the FlowMatch Euler schedule, the txt2img loop with the
  velocity cache, the dual-ControlNet true-CFG inpaint loop, the ControlNet,
  joint and base-only training steps, the OCR text-perceptual loss and the
  elastic training loop;
- ``eval``: the OCR judge (CTC recognizer on ``benchmarks/ocr_judge.npz``);
- ``pipelines``: the txt2img and text-inpainting pipelines;
- ``parallel``: sequence parallelism (SP groups over ``torch.distributed``,
  the ring, all-gather and Ulysses attention, the SP forward; ranks as
  threads of one process for the tests);
- ``data``, ``data_disk``: step-indexed synthetic glyph and photo-corpus
  training batches and their prefetcher;
- ``io``: Flax-tree -> module weight carry (``load_jax_params``);
- ``cli``: the txt2img, inpaint and train command line;
- ``benchmarks``: the attention A/B study on the card (``sweep_attention``,
  ``exp_softmax_overlap``);
- ``configs``, ``conditioning``, ``text``, ``utils``: the port's own copies
  of the JAX package's host code (dataclasses, glyph conditioning, token and
  image helpers).

This package imports neither jax nor anything of the JAX package
(``reptext_tpu``); converted checkpoints reach it as numpy trees.
"""

__version__ = "0.1.0"
