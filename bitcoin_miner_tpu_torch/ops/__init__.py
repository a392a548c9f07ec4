"""Scan kernels and their plain PyTorch versions."""
