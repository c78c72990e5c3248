"""PyTorch modules of the port: layers, embeddings, MMDiT blocks, VAE, CLIP, T5."""
