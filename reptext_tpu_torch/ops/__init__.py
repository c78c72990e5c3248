"""Tensor ops of the port: latents, RoPE, attention, and the CUDA attention and ring-step kernels."""
