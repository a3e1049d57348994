"""Training (JAX ``train/``): U-Net loops (``torch.optim.AdamW`` + cosine),
affine augmentation, checkpoints, local experiment logging."""
