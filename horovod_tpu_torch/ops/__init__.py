"""Collectives, compression and the CUDA wire-compression kernels."""
