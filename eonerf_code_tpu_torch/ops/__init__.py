"""Sampling, volume rendering, the fused render kernels and rasterisation."""
