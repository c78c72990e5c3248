"""Tensor ops of the port: latents, RoPE, attention and the CUDA flash-attention kernel."""
