"""Weights: the safetensors reader and writer, the diffusers -> Flax-named
converters and their command line, the port's checkpoint directory, and the
carry of Flax parameter trees into the port's modules."""
