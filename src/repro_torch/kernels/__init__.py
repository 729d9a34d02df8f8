"""Kernels of the port: plain PyTorch versions and Hopper CUDA kernels."""
