"""Distances and the fused distance + top-k kernels."""
