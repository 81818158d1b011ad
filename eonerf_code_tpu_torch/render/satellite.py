"""The satellite renderer: one pass over a block of rays.

stratified sampling -> field -> camera compositing -> shadow-ray sampling
from the expected surface point toward the sun -> sigma-only field -> sun
visibility -> irradiance + radiometric composite. A field with fused ops
(``KernelField``) runs the per-sample work inside the fused camera and
shadow kernels; any other field runs it per sample through the module.

Physics and composite (the reference's, as in the JAX package):
- rgb = albedo*s + (1-s) * (0.2*ambient) * albedo, with s = geometric sun
  visibility * transient scalar when shadows are on, s = 1 before
  (sat_rendering.py:265-306);
- the shadow pass reads the EXCLUSIVE transmittance at the last in-cube
  sample of a ray marched from the camera ray's expected surface point
  toward the sun (sat_rendering.py:87-118);
- per-image radiometric transform rgb' = A*rgb + b clipped to [0, 1];
  ``shadowless_rgb`` = A*albedo + b, unclipped;
- beta gets +beta_min after accumulation.

Random numbers come from an explicit ``torch.Generator`` (the JAX package
takes a PRNG key); the two give different numbers from one seed, so parity
is checked with ``perturb=False``.
"""

import dataclasses

import torch

from eonerf_code_tpu_torch.data.rays import SatRays
from eonerf_code_tpu_torch.ops.sampling import (
    cube_mask,
    intervals_from_z,
    linear_z_vals,
    perturb_z_vals,
    set_last_valid,
    stratified_z_vals,
)
from eonerf_code_tpu_torch.ops.volrend import accumulate, exit_transmittance, render_weights

OUTPUT_KEYS = ("rgb", "depth", "albedo_rgb", "ambient_rgb", "geo_shadows", "transient_s",
               "beta", "entropy", "pts_per_ray", "sc_pts_per_ray", "opacity",
               "opacity_after_surface", "shadowless_rgb")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Rendering options. Occupancy tightening, ray entropy and the nadir
    opacity diagnostics of the JAX package's RenderConfig arrive with later
    slices of the port."""

    n_samples: int = 128       # z values per camera ray (intervals = n-1)
    sc_n_samples: int = 128    # z values per shadow ray
    n_importance: int = 0      # hierarchical fine samples (not in this slice)
    perturb: bool = True       # reference quirk: perturbed in train AND eval
    cube_bound: float = 1.0
    ambient_scale: float = 0.2
    ray_span: float = 2.0      # rays sampled on [near, near + 2]
    inf_delta: float = 1e10


def _check_supported(cfg, occ_grid):
    if cfg.n_importance > 0:
        raise NotImplementedError(
            "n_importance > 0 (hierarchical sampling) comes with the port's "
            "hierarchical-sampling slice, together with the coarse kernel")
    if occ_grid is not None:
        raise NotImplementedError(
            "occupancy grids come with the port's occupancy slice")


def _sample_block(origins, viewdirs, near, n_samples, span, perturb, bound, generator):
    """Stratified z on [near, near + span]; returns (pos, z_mid, delta, mask)."""
    z_vals = stratified_z_vals(near, near + span, n_samples, perturb=perturb,
                               generator=generator)
    _, _, z_mid, delta = intervals_from_z(z_vals)
    pos = origins[:, None, :] + viewdirs[:, None, :] * z_mid[..., None]
    return pos, z_mid, delta, cube_mask(pos, bound)


def _camera_samples(o, d, near, cfg: RenderConfig, generator):
    """Camera-ray samples (z_mid, delta, pos, mask). A ray whose samples all
    fall outside the cube is re-sampled on the default range [0, span]
    (sat_rendering.py:259-262, per ray here), with the same jitter."""
    z_lin = linear_z_vals(near, near + cfg.ray_span, cfg.n_samples)
    z_dflt = linear_z_vals(torch.zeros_like(near), torch.full_like(near, cfg.ray_span),
                           cfg.n_samples)
    if cfg.perturb:
        u = torch.rand(z_lin.shape, dtype=z_lin.dtype, device=z_lin.device,
                       generator=generator)
        z_lin, z_dflt = perturb_z_vals(z_lin, u), perturb_z_vals(z_dflt, u)
    _, _, z_mid0, _ = intervals_from_z(z_lin)
    pos0 = o[:, None, :] + d[:, None, :] * z_mid0[..., None]
    has_valid = cube_mask(pos0, cfg.cube_bound).any(dim=-1)
    z_vals = torch.where(has_valid[:, None], z_lin, z_dflt)
    _, _, z_mid, delta = intervals_from_z(z_vals)
    pos = o[:, None, :] + d[:, None, :] * z_mid[..., None]
    return z_mid, delta, pos, cube_mask(pos, cfg.cube_bound)


def _corrected_origins(field, rays):
    o = rays.origins
    if field.rpc_correction:
        o = o + field.ray_offset(rays.img_idx)
    return o


def _composite(field, rays, cfg, albedo_acc, ambient_acc, t_s_acc, geo_shadow, shadows):
    """Irradiance + radiometric composite. Returns (rgb, shadowless_rgb)."""
    s = geo_shadow * t_s_acc if shadows else geo_shadow  # no transient factor before shadows
    rgb = albedo_acc * s + (1.0 - s) * (ambient_acc * albedo_acc)
    a_coef, b_coef, _ambient_bias = field.radiometric(rays.img_idx)
    return (a_coef * rgb + b_coef).clamp(0.0, 1.0), a_coef * albedo_acc + b_coef


def render_rays(field, rays: SatRays, cfg: RenderConfig, shadows: bool, generator=None,
                occ_grid=None):
    """Render one block of rays; a dict of the 13 per-ray outputs of
    ``OUTPUT_KEYS`` (the reference's result keys, sat_rendering.py:322-334).
    Fields with fused ops take the fused branch, same math and keys."""
    _check_supported(cfg, occ_grid)
    if getattr(field, "supports_fused_render", False):
        return _render_rays_fused(field, rays, cfg, shadows, generator)
    d, sun_d = rays.viewdirs, rays.sundirs
    o = _corrected_origins(field, rays)
    near = rays.t_near

    z_mid, delta, pos, mask = _camera_samples(o, d, near, cfg, generator)
    delta_cam = set_last_valid(delta, mask, cfg.inf_delta)
    sigma, albedo, ambient, t_s, t_beta = field(pos, sun_d, rays.img_idx)
    weights, _, _ = render_weights(sigma, delta_cam, mask)
    depth = accumulate(weights, z_mid)
    albedo_acc = accumulate(weights, albedo)
    t_s_acc = accumulate(weights, t_s[..., 0])[:, None]
    beta_acc = accumulate(weights, t_beta[..., 0])[:, None] + field.beta_min
    opacity = accumulate(weights)
    # ambient is constant along a ray: its accumulation is ambient * opacity
    ambient_acc = ambient * opacity[:, None] * cfg.ambient_scale

    if shadows:
        sc_o = o + depth[:, None] * d
        sc_pos, _, sc_delta, sc_mask = _sample_block(
            sc_o, -sun_d, torch.zeros_like(near), cfg.sc_n_samples, cfg.ray_span,
            cfg.perturb, cfg.cube_bound, generator)
        sc_sigma = field.density(sc_pos)
        geo_shadow = exit_transmittance(sc_sigma, sc_delta, sc_mask)[:, None]
        sc_pts = sc_mask.sum(dim=-1).to(albedo_acc.dtype)[:, None]
    else:
        geo_shadow = torch.ones_like(t_s_acc)
        sc_pts = torch.ones_like(t_s_acc)
    rgb, shadowless_rgb = _composite(field, rays, cfg, albedo_acc, ambient_acc, t_s_acc,
                                     geo_shadow, shadows)
    return _outputs(rgb, depth, albedo_acc, ambient_acc, geo_shadow, t_s_acc, beta_acc,
                    mask, sc_pts, opacity, shadowless_rgb)


def _outputs(rgb, depth, albedo_acc, ambient_acc, geo_shadow, t_s_acc, beta_acc, mask,
             sc_pts, opacity, shadowless_rgb):
    ones = torch.ones_like(depth[:, None])
    return {
        "rgb": rgb,
        "depth": depth[:, None],
        "albedo_rgb": albedo_acc,
        "ambient_rgb": ambient_acc,
        "geo_shadows": geo_shadow,
        "transient_s": t_s_acc,
        "beta": beta_acc,
        "entropy": ones,                                   # ray entropy: later slice
        "pts_per_ray": mask.sum(dim=-1).to(albedo_acc.dtype)[:, None],
        "sc_pts_per_ray": sc_pts,
        "opacity": opacity[:, None],
        "opacity_after_surface": ones.expand(-1, 2).clone(),  # nadir diagnostics: later slice
        "shadowless_rgb": shadowless_rgb,
    }


def _render_rays_fused(field, rays: SatRays, cfg: RenderConfig, shadows: bool, generator):
    """render_rays' fused branch: sampling and the per-ray composite stay in
    PyTorch, the per-sample work runs in the fused camera and shadow ops
    with per-ray input. Differentiable; nothing here writes in place into a
    tensor autograd needs."""
    d, sun_d = rays.viewdirs, rays.sundirs
    o = _corrected_origins(field, rays)
    near = rays.t_near
    r = o.shape[0]

    z_mid, delta, _, mask = _camera_samples(o, d, near, cfg, generator)
    deltam = set_last_valid(delta, mask, cfg.inf_delta) * mask
    w = field.pack()
    emb = field.transient_embedding(rays.img_idx).to(o.dtype)
    rayin = torch.cat([o, d, emb, torch.zeros((r, 6), dtype=o.dtype, device=o.device)], dim=1)
    acc = field.fused_camera(w, rayin.contiguous(), z_mid.contiguous(), deltam.contiguous())
    depth = acc[:, 0]
    albedo_acc = acc[:, 1:4]
    t_s_acc = acc[:, 4:5]
    beta_acc = acc[:, 5:6] + field.beta_min
    opacity = acc[:, 6]
    ambient_acc = field.ambient(sun_d) * opacity[:, None] * cfg.ambient_scale

    if shadows:
        sc_o = o + depth[:, None] * d
        sc_d = -sun_d
        # the march is sampled from the detached origin; the gradient reaches
        # sc_o (and through it depth) only through rayin_sc
        _, sc_z, sc_delta, sc_mask = _sample_block(
            sc_o.detach(), sc_d, torch.zeros_like(near), cfg.sc_n_samples, cfg.ray_span,
            cfg.perturb, cfg.cube_bound, generator)
        rayin_sc = torch.cat([sc_o, sc_d, torch.zeros((r, 10), dtype=o.dtype, device=o.device)],
                             dim=1)
        geo = field.fused_shadow(w, rayin_sc.contiguous(), sc_z.contiguous(),
                                 (sc_delta * sc_mask).contiguous(), sc_mask.float())
        geo_shadow = geo[:, None]
        sc_pts = sc_mask.sum(dim=-1).to(albedo_acc.dtype)[:, None]
    else:
        geo_shadow = torch.ones_like(t_s_acc)
        sc_pts = torch.ones_like(t_s_acc)
    rgb, shadowless_rgb = _composite(field, rays, cfg, albedo_acc, ambient_acc, t_s_acc,
                                     geo_shadow, shadows)
    return _outputs(rgb, depth, albedo_acc, ambient_acc, geo_shadow, t_s_acc, beta_acc,
                    mask, sc_pts, opacity, shadowless_rgb)


def render_depth(field, rays: SatRays, cfg: RenderConfig, generator=None, occ_grid=None):
    """Depth only, (R, 1) (reference sat_rendering.py:227-249): sigma-only
    per-sample passes, or the fused camera op's depth column on a
    kernel-backed field."""
    _check_supported(cfg, occ_grid)
    o = _corrected_origins(field, rays)
    z_mid, delta, pos, mask = _camera_samples(o, rays.viewdirs, rays.t_near, cfg, generator)
    delta_cam = set_last_valid(delta, mask, cfg.inf_delta)
    if getattr(field, "supports_fused_render", False):
        r = o.shape[0]
        rayin = torch.cat([o, rays.viewdirs,
                           torch.zeros((r, 10), dtype=o.dtype, device=o.device)], dim=1)
        acc = field.fused_camera(field.pack(), rayin.contiguous(), z_mid.contiguous(),
                                 (delta_cam * mask).contiguous())
        return acc[:, 0:1]
    weights, _, _ = render_weights(field.density(pos), delta_cam, mask)
    return accumulate(weights, z_mid)[:, None]


@torch.no_grad()
def render_image(field, rays: SatRays, cfg: RenderConfig, shadows: bool, chunk: int = 4096,
                 generator=None, occ_grid=None, depth_only: bool = False):
    """Render any number of rays as a loop over ``chunk``-ray blocks (the
    last may be shorter); returns a dict of (N, ...) outputs, ``{"depth"}``
    alone with ``depth_only``. Peak memory is bounded by the chunk."""
    _check_supported(cfg, occ_grid)
    n = rays.origins.shape[0]
    outs = []
    for start in range(0, n, chunk):
        block = SatRays(*(x[start:start + chunk] for x in rays))
        if depth_only:
            outs.append({"depth": render_depth(field, block, cfg, generator)})
        else:
            outs.append(render_rays(field, block, cfg, shadows, generator))
    return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}
