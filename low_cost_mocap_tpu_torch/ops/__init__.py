"""Tensor ops of the PyTorch port, with the hand-written CUDA kernels
beside their plain PyTorch versions."""
