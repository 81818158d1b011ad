"""Sinusoidal positional encoding.

Same layout as the JAX package's encoder (and the reference encoder):
frequencies 2^i for i in [min_deg, max_deg), degree-major, the latent is
[identity | sin(x*2^i) | cos(x*2^i)] with the cosine block written as
sin(xb + pi/2).
"""

import math

import torch


def sinusoidal_latent_dim(x_dim, min_deg, max_deg, use_identity=True):
    return (int(use_identity) + (max_deg - min_deg) * 2) * x_dim


def sinusoidal_encode(x, min_deg, max_deg, use_identity=True):
    """Encode (..., x_dim) -> (..., latent_dim)."""
    if max_deg == min_deg:
        return x
    scales = torch.tensor([2.0**i for i in range(min_deg, max_deg)],
                          dtype=x.dtype, device=x.device)
    # (..., L, x_dim) -> (..., L*x_dim): degree-major
    xb = (x[..., None, :] * scales[:, None]).reshape(
        *x.shape[:-1], (max_deg - min_deg) * x.shape[-1])
    latent = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
    if use_identity:
        latent = torch.cat([x, latent], dim=-1)
    return latent
