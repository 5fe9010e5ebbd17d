"""Compiler, cost evaluation, factor contraction and the CUDA kernels."""
