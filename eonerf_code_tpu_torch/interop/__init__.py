"""Interchange with the JAX package's parameter format."""
