"""Kernels, their plain PyTorch versions, and the codec stages."""
