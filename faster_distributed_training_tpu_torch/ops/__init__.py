"""Kernels of the port and their plain PyTorch versions, plus the plain
ops around them (hash dropout, LayerNorm)."""
