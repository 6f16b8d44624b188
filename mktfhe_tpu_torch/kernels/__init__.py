"""Hand-written CUDA kernels and their wrappers.

Each wrapper launches its kernel on CUDA tensors (or raises) and runs the
kernel's plain PyTorch twin on CPU tensors.
"""
