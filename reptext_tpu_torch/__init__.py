"""reptext-tpu's PyTorch + CUDA port, for NVIDIA Hopper (H100).

A second package beside the JAX reference ``reptext_tpu``, with the same
sub-package names:

- ``ops``: latents, RoPE, the attention entry point, and the hand-written
  CUDA flash-attention kernel (``csrc/flash_attention.cu``) with its build
  (``ops/_build.py``) and plain PyTorch twin;
- ``nn``: layers, embeddings, MMDiT blocks, VAE, CLIP and T5 encoders;
- ``models``: the FLUX transformer and the RepText ControlNet;
- ``sampling``: the FlowMatch Euler schedule and the txt2img loop;
- ``pipelines``: the txt2img pipeline;
- ``io``: Flax-tree -> module weight carry (``load_jax_params``);
- ``cli``: the txt2img command line.

Host-only code is shared with the JAX package (``reptext_tpu.configs``,
``conditioning``, ``text``, ``utils.image``, ``io.convert``); none of it
loads JAX unless ``JAX_PLATFORMS`` is set. This package never imports jax.
"""

__version__ = "0.1.0"
