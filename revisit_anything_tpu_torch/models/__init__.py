"""PyTorch models of the serving slice: SAM and DINOv2."""
