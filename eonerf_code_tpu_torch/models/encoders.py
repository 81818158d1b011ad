"""Sinusoidal positional encoding and its coarse-to-fine annealing mask
(the JAX package's models/encoders.py).

Same layout as the JAX package's encoder (and the reference encoder):
frequencies 2^i for i in [min_deg, max_deg), degree-major, the latent is
[identity | sin(x*2^i) | cos(x*2^i)] with the cosine block written as
sin(xb + pi/2). ``freq_mask`` multiplies the latent; ``barf_alpha`` and
``barf_freq_mask`` give the mask of a training step (BARF, Lin et al.
2021), computed in float32 as the JAX package computes it.
"""

import math

import torch


def sinusoidal_latent_dim(x_dim, min_deg, max_deg, use_identity=True):
    return (int(use_identity) + (max_deg - min_deg) * 2) * x_dim


def sinusoidal_encode(x, min_deg, max_deg, use_identity=True, freq_mask=None):
    """Encode (..., x_dim) -> (..., latent_dim), times ``freq_mask``
    (latent_dim,) when given."""
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
    if freq_mask is not None:
        latent = latent * freq_mask
    return latent


def barf_alpha(step, start_step, end_step, n_freqs, device="cpu"):
    """Annealing progress, a float32 scalar tensor on ``device``: 0 up to
    ``start_step``, ramping linearly to ``n_freqs`` at ``end_step`` and
    held there (JAX ``barf_alpha``)."""
    t = ((torch.as_tensor(step, dtype=torch.float32, device=device) - start_step)
         / max(end_step - start_step, 1))
    return t.clamp(0.0, 1.0) * n_freqs


def barf_freq_mask(alpha, x_dim, min_deg, max_deg, use_identity=True, dtype=torch.float32,
                   device="cpu"):
    """(latent_dim,) annealing mask for ``sinusoidal_encode``'s layout
    [identity | sin (degree-major) | cos] (JAX ``barf_freq_mask``): band k
    in [0, L) weighs 0.5 (1 - cos(pi clip(alpha - k, 0, 1))), off above
    alpha, eased through the band alpha is in, 1 below; the identity always
    1. Computed in float32 on ``device``, returned in ``dtype``."""
    n = max_deg - min_deg
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    k = torch.arange(n, dtype=torch.float32, device=device)
    w = 0.5 * (1.0 - torch.cos(math.pi * (alpha - k).clamp(0.0, 1.0)))
    band = w.repeat_interleave(x_dim)                 # degree-major, x_dim each
    parts = ([torch.ones(x_dim, dtype=torch.float32, device=device)] if use_identity
             else []) + [band, band]
    return torch.cat(parts).to(dtype)
