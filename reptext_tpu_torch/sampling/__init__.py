"""FlowMatch schedule and the txt2img denoising loop (PyTorch)."""
