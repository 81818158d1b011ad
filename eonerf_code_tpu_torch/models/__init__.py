"""Radiance-field models (PyTorch) and the kernel-backed render field."""
