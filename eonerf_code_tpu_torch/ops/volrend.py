"""Volume rendering over dense (rays, samples) blocks.

Exclusive-cumsum transmittance and masked reductions (nerfacc's
formulation, reference radiance_fields/eonerf.py:229-242 and
sat_rendering.py:106-116). Invalid samples carry zero density.
"""

import math

import torch


def exclusive_cumsum(x):
    """out_i = sum_{j<i} x_j, by SHIFTING first. Never cumsum(x) - x: that
    cancels catastrophically in float32 against the camera pass's 1e10
    last-interval sentinel."""
    return torch.cat([torch.zeros_like(x[..., :1]), torch.cumsum(x[..., :-1], dim=-1)],
                     dim=-1)


def render_weights(sigma, delta, mask=None):
    """(weights, transmittance, alphas), each (R, K):
    T_i = exp(-sum_{j<i} sigma_j delta_j), alpha_i = 1 - exp(-sigma_i delta_i),
    w_i = T_i alpha_i."""
    if mask is not None:
        sigma = torch.where(mask, sigma, torch.zeros_like(sigma))
    sdelta = sigma * delta
    trans = torch.exp(-exclusive_cumsum(sdelta))
    alphas = 1.0 - torch.exp(-sdelta)
    return trans * alphas, trans, alphas


def exit_transmittance(sigma, delta, mask=None):
    """EXCLUSIVE transmittance at the last valid sample of each ray, (R,) —
    the geometric sun-visibility readout (sat_rendering.py:106-116). Rays
    with no valid sample return 1."""
    if mask is None:
        mask = torch.ones(sigma.shape, dtype=torch.bool, device=sigma.device)
    sigma = torch.where(mask, sigma, torch.zeros_like(sigma))
    sdelta = sigma * delta
    k = mask.shape[-1]
    last_idx = k - 1 - torch.argmax(mask.flip(-1).to(torch.int32), dim=-1)
    excl = exclusive_cumsum(sdelta)
    return torch.exp(-torch.gather(excl, -1, last_idx[:, None])[:, 0])


def ray_entropy(alphas, mask=None, eps=1e-10):
    """InfoNeRF per-ray opacity entropy (R, K) -> (R,) (reference
    eonerf.py:56-67, computed but disabled there): p_i = alpha_i / sum
    alpha over the valid samples, H = -sum p_i log10(p_i + eps)."""
    if mask is not None:
        alphas = torch.where(mask, alphas, torch.zeros_like(alphas))
    p = alphas / (alphas.sum(dim=-1, keepdim=True) + eps)
    return -(p * torch.log10(p + eps)).sum(dim=-1)


def weight_entropy(weights, eps=1e-10):
    """Per-ray entropy of the normalized compositing weights (R, K) -> (R,),
    scaled to [0, 1] by log(K): about 0 when a ray's mass sits on one
    sample, 1 when it is spread evenly. The trainer's entropy gate reads
    it."""
    k = weights.shape[-1]
    p = weights / (weights.sum(dim=-1, keepdim=True) + eps)
    return -(p * torch.log(p + eps)).sum(dim=-1) / math.log(k)


def accumulate(weights, values=None):
    """Weighted reduction along samples. weights (R, K); values (R, K, C),
    (R, K) or None (-> opacity). Returns (R, C) or (R,)."""
    if values is None:
        return weights.sum(dim=-1)
    if values.dim() == weights.dim():
        return (weights * values).sum(dim=-1)
    return (weights[..., None] * values).sum(dim=-2)
