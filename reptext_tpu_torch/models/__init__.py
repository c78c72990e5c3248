"""The FLUX transformer and the RepText ControlNet (PyTorch)."""
