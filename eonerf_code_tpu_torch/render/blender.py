"""Occupancy-grid NeRF rendering of Blender scenes, as the JAX package's
render/blender.py: every ray carries ``n_samples`` z values, evenly spaced
on [near, far] and jittered in training, with the samples at the interval
midpoints; the occupancy grid masks the density of empty space (it does
not compact the samples).
"""

import dataclasses

import torch

from eonerf_code_tpu_torch.ops.sampling import intervals_from_z, perturb_z_vals, uniform
from eonerf_code_tpu_torch.ops.volrend import accumulate, render_weights


@dataclasses.dataclass(frozen=True)
class BlenderRenderConfig:
    n_samples: int = 129          # -> 128 intervals
    near: float = 2.0
    far: float = 6.0
    perturb: bool = True


def render_blender_rays(model, rays_o, rays_d, color_bkgd, cfg, occ_grid=None, train=True,
                        generator=None, u=None):
    """dict(rgb (n, 3) composited on ``color_bkgd``, opacity (n, 1), depth
    (n, 1), n_eff_samples). The jitter (``cfg.perturb`` and ``train``) is
    ``u`` (n, n_samples) when given, else drawn from ``generator``. A
    sample counts where it lies inside |pos| < the grid's ``aabb_max`` on
    every axis and in an occupied cell; without a grid every sample
    counts."""
    n = rays_o.shape[0]
    steps = torch.linspace(0.0, 1.0, cfg.n_samples, dtype=rays_o.dtype, device=rays_o.device)
    z = (cfg.near * (1 - steps) + cfg.far * steps).expand(n, cfg.n_samples)
    if cfg.perturb and train:
        if u is None:
            u = uniform(z.shape, z.dtype, z.device, generator)
        z = perturb_z_vals(z, u)
    _, _, z_mid, delta = intervals_from_z(z)
    pos = rays_o[:, None, :] + rays_d[:, None, :] * z_mid[..., None]
    mask = None
    if occ_grid is not None:
        inside = (pos.abs() < occ_grid.aabb_max).all(dim=-1)
        mask = inside & occ_grid.query(pos)
    rgb, sigma = model(pos, rays_d[:, None, :])
    weights, _, _ = render_weights(sigma, delta, mask)
    opacity = accumulate(weights)
    depth = accumulate(weights, z_mid)
    color = accumulate(weights, rgb) + (1.0 - opacity)[:, None] * color_bkgd
    if mask is not None:
        n_eff = mask.sum()
    else:
        n_eff = torch.tensor(weights.numel(), device=weights.device)
    return {"rgb": color, "opacity": opacity[:, None], "depth": depth[:, None],
            "n_eff_samples": n_eff}
