"""The satellite renderer: one pass over a block of rays.

stratified sampling (optionally tightened to the occupancy grid's span, and
refined by hierarchical fine samples from a coarse density pass) -> field
-> camera compositing -> shadow-ray sampling from the expected surface
point toward the sun -> sigma-only field -> sun visibility -> irradiance +
radiometric composite. A field with fused ops (``KernelField``) runs the
per-sample work inside the fused camera, shadow and coarse kernels, unless
``compute_entropy`` or ``nadir_diagnostics`` asks for the per-sample
branch, which evaluates the field per point (on a ``KernelField`` through
the per-point field and density kernels, on any other field through the
module) and composites in PyTorch.

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

An occupancy grid (``occ_grid``) is used one of two ways: with
``occ_tighten`` each camera ray samples its occupied span
(``OccupancyGrid.ray_span``; with ``occ_tighten_shadows`` the shadow march
too), a random ``occ_explore_frac`` of the rays keeping the full range;
without it, samples in empty cells are masked out.

Random numbers come from an explicit ``torch.Generator`` (the JAX package
takes a PRNG key); the two give different numbers from one seed, so parity
is checked with ``perturb=False`` and ``occ_explore_frac=0``.
"""

import dataclasses

import torch

from eonerf_code_tpu_torch.data.rays import SatRays
from eonerf_code_tpu_torch.ops.sampling import (
    DrawLog,
    cube_mask,
    intervals_from_z,
    linear_z_vals,
    perturb_z_vals,
    sample_pdf,
    set_last_valid,
    skip_draws,
    stratified_z_vals,
    uniform,
)
from eonerf_code_tpu_torch.ops.volrend import (
    accumulate,
    exit_transmittance,
    ray_entropy,
    render_weights,
)

OUTPUT_KEYS = ("rgb", "depth", "albedo_rgb", "ambient_rgb", "geo_shadows", "transient_s",
               "beta", "entropy", "pts_per_ray", "sc_pts_per_ray", "opacity",
               "opacity_after_surface", "shadowless_rgb")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Rendering options, as the JAX package's RenderConfig."""

    n_samples: int = 128       # z values per camera ray (intervals = n-1)
    sc_n_samples: int = 128    # z values per shadow ray
    n_importance: int = 0      # hierarchical fine samples from the coarse weights
    perturb: bool = True       # reference quirk: perturbed in train AND eval
    cube_bound: float = 1.0
    ambient_scale: float = 0.2
    ray_span: float = 2.0      # rays sampled on [near, near + 2]
    inf_delta: float = 1e10
    occ_tighten: bool = False  # camera rays sample their occupied span (needs occ_grid)
    occ_tighten_shadows: bool = False  # the same for the shadow march
    occ_probes: int = 64       # probes per ray of the span walk
    occ_margin: float = 2.0    # span widening, in probe spacings
    occ_explore_frac: float = 0.25  # share of rays that keep the full range (0 for eval)
    compute_entropy: bool = False   # InfoNeRF ray entropy (the reference computes, then
                                    # drops it; off: ones)
    nadir_diagnostics: bool = False  # opacity below/above the surface along vertical probes
                                     # (sat_rendering.py:146-174; off: ones)


def _with_exploration(generator, t_lo, t_hi, near, far, frac):
    """A random ``frac`` of the rays keeps its full [near, far] range (all (R,))
    despite the occupancy span: exploring rays regrow density wherever the
    grid is wrong, and the next grid update widens the spans."""
    if frac <= 0.0:
        return t_lo, t_hi
    explore = uniform(t_lo.shape, t_lo.dtype, t_lo.device, generator) < frac
    return torch.where(explore, near, t_lo), torch.where(explore, far, t_hi)


def _sample_block(origins, viewdirs, near, n_samples, span, perturb, bound, generator,
                  far=None):
    """Stratified z on [near, far] (far = near + span unless given per ray);
    returns (pos, z_mid, delta, mask)."""
    far = near + span if far is None else far
    z_vals = stratified_z_vals(near, far, n_samples, perturb=perturb, generator=generator)
    _, _, z_mid, delta = intervals_from_z(z_vals)
    pos = origins[:, None, :] + viewdirs[:, None, :] * z_mid[..., None]
    return pos, z_mid, delta, cube_mask(pos, bound)


def _camera_samples(o, d, near, cfg: RenderConfig, generator, field=None, occ_grid=None,
                    weights=None):
    """Camera-ray samples (z_mid, delta, pos, mask).

    - With ``occ_tighten`` and a grid, each ray's range is first tightened
      to its occupied span (with exploration); else [near, near + span].
    - A ray whose samples all fall outside the cube is re-sampled on the
      default range [0, span] (sat_rendering.py:259-262, per ray here),
      with the same jitter draw.
    - With ``n_importance`` > 0, fine samples are drawn from the weights of
      a density-only coarse pass over those samples (the fused coarse op on
      a kernel-backed field, whose packed ``weights`` may be handed in) and
      merged, sorted, detached from autograd."""
    far = near + cfg.ray_span
    z_dflt = linear_z_vals(torch.zeros_like(near), torch.full_like(near, cfg.ray_span),
                           cfg.n_samples)
    u = uniform(z_dflt.shape, z_dflt.dtype, z_dflt.device, generator) if cfg.perturb else None
    if occ_grid is not None and cfg.occ_tighten:
        t_lo, t_hi = occ_grid.ray_span(o, d, near, far, n_probes=cfg.occ_probes,
                                       margin=cfg.occ_margin)
        t_lo, t_hi = _with_exploration(generator, t_lo, t_hi, near, far, cfg.occ_explore_frac)
    else:
        t_lo, t_hi = near, far
    z_lin = linear_z_vals(t_lo, t_hi, cfg.n_samples)
    if cfg.perturb:
        z_lin, z_dflt = perturb_z_vals(z_lin, u), perturb_z_vals(z_dflt, u)
    _, _, z_mid0, _ = intervals_from_z(z_lin)
    pos0 = o[:, None, :] + d[:, None, :] * z_mid0[..., None]
    has_valid = cube_mask(pos0, cfg.cube_bound).any(dim=-1)
    z_vals = torch.where(has_valid[:, None], z_lin, z_dflt)
    if cfg.n_importance > 0:
        with torch.no_grad():
            _, _, zc_mid, c_delta = intervals_from_z(z_vals)
            c_pos = o[:, None, :] + d[:, None, :] * zc_mid[..., None]
            c_mask = cube_mask(c_pos, cfg.cube_bound)
            c_deltam = set_last_valid(c_delta, c_mask, cfg.inf_delta)
            if getattr(field, "supports_fused_render", False):
                rayin = torch.cat([o, d, torch.zeros((o.shape[0], 10), dtype=o.dtype,
                                                     device=o.device)], dim=1)
                c_w = field.fused_coarse(field.pack() if weights is None else weights,
                                         rayin.contiguous(), zc_mid.contiguous(),
                                         (c_deltam * c_mask).contiguous())
            else:
                c_w, _, _ = render_weights(field.density(c_pos), c_deltam, c_mask)
            z_fine = sample_pdf(z_vals, c_w, cfg.n_importance, perturb=cfg.perturb,
                                generator=generator)
        z_vals = torch.sort(torch.cat([z_vals, z_fine], dim=-1), dim=-1).values
    _, _, z_mid, delta = intervals_from_z(z_vals)
    pos = o[:, None, :] + d[:, None, :] * z_mid[..., None]
    return z_mid, delta, pos, cube_mask(pos, cfg.cube_bound)


def _shadow_samples(sc_o, sc_d, near, cfg: RenderConfig, generator, occ_grid):
    """Shadow-march samples (pos, z_mid, delta, mask) from the surface
    points ``sc_o``, tightened to the occupied span with
    ``occ_tighten_shadows`` and a grid (sat_rendering.py's march otherwise).
    The span walk reads the detached points."""
    if occ_grid is not None and cfg.occ_tighten_shadows:
        sc_lo, sc_hi = occ_grid.ray_span(sc_o.detach(), sc_d, near, cfg.ray_span,
                                         n_probes=cfg.occ_probes, margin=cfg.occ_margin)
        sc_lo, sc_hi = _with_exploration(generator, sc_lo, sc_hi, near, near + cfg.ray_span,
                                         cfg.occ_explore_frac)
    else:
        sc_lo, sc_hi = near, None
    return _sample_block(sc_o, sc_d, sc_lo, cfg.sc_n_samples, cfg.ray_span, cfg.perturb,
                         cfg.cube_bound, generator, far=sc_hi)


def _nadir_opacity_diagnostics(field, origins, cfg: RenderConfig, generator):
    """Mean alpha over the in-cube samples of vertical probes from the
    expected surface points ``origins``, downward (column 0) and upward
    (column 1): a density-leakage diagnostic (reference
    ``compute_nadir_rays_v2``, sat_rendering.py:146-174). ``sc_n_samples``
    z values on [0, ray_span], one jitter draw for both probes, as the JAX
    package reuses one key. (R, 2)."""
    r = origins.shape[0]
    zeros = torch.zeros((r,), dtype=origins.dtype, device=origins.device)
    z_vals = stratified_z_vals(zeros, zeros + cfg.ray_span, cfg.sc_n_samples,
                               perturb=cfg.perturb, generator=generator)
    _, _, z_mid, delta = intervals_from_z(z_vals)
    outs = []
    for direction in (-1.0, 1.0):
        pos = origins[:, None, :] + origins.new_tensor([0.0, 0.0, direction]) * z_mid[..., None]
        mask = cube_mask(pos, cfg.cube_bound)
        _, _, alphas = render_weights(field.density(pos), delta, mask)
        n = mask.sum(dim=-1).clamp(min=1)
        outs.append(torch.where(mask, alphas, torch.zeros_like(alphas)).sum(dim=-1) / n)
    return torch.stack(outs, dim=-1)


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
    Fields with fused ops take the fused branch, same math and keys, unless
    ``compute_entropy`` or ``nadir_diagnostics`` is set: the two outputs
    that need per-sample alphas. On the per-sample branch the shadow march
    starts from the live surface point, so the shadow term's gradient
    reaches the camera depth through the sample positions."""
    if (getattr(field, "supports_fused_render", False)
            and not cfg.compute_entropy and not cfg.nadir_diagnostics):
        return _render_rays_fused(field, rays, cfg, shadows, generator, occ_grid)
    d, sun_d = rays.viewdirs, rays.sundirs
    o = _corrected_origins(field, rays)
    near = rays.t_near

    z_mid, delta, pos, mask = _camera_samples(o, d, near, cfg, generator, field, occ_grid)
    if occ_grid is not None and not cfg.occ_tighten:
        # empty-space masking (tightening concentrates the samples instead;
        # masking there would zero the fallback rays' density)
        mask = mask & occ_grid.query(pos)
    delta_cam = set_last_valid(delta, mask, cfg.inf_delta)
    sigma, albedo, ambient, t_s, t_beta = field(pos, sun_d, rays.img_idx)
    weights, _, alphas = render_weights(sigma, delta_cam, mask)
    depth = accumulate(weights, z_mid)
    albedo_acc = accumulate(weights, albedo)
    t_s_acc = accumulate(weights, t_s[..., 0])[:, None]
    beta_acc = accumulate(weights, t_beta[..., 0])[:, None] + field.beta_min
    opacity = accumulate(weights)
    # ambient is constant along a ray: its accumulation is ambient * opacity
    ambient_acc = ambient * opacity[:, None] * cfg.ambient_scale

    if shadows:
        sc_o = o + depth[:, None] * d
        sc_pos, _, sc_delta, sc_mask = _shadow_samples(sc_o, -sun_d, torch.zeros_like(near), cfg,
                                                       generator, occ_grid)
        sc_sigma = field.density(sc_pos)
        geo_shadow = exit_transmittance(sc_sigma, sc_delta, sc_mask)[:, None]
        sc_pts = sc_mask.sum(dim=-1).to(albedo_acc.dtype)[:, None]
    else:
        geo_shadow = torch.ones_like(t_s_acc)
        sc_pts = torch.ones_like(t_s_acc)
    rgb, shadowless_rgb = _composite(field, rays, cfg, albedo_acc, ambient_acc, t_s_acc,
                                     geo_shadow, shadows)
    entropy = ray_entropy(alphas, mask)[:, None] if cfg.compute_entropy else None
    after = (_nadir_opacity_diagnostics(field, o + depth[:, None] * d, cfg, generator)
             if cfg.nadir_diagnostics else None)
    return _outputs(rgb, depth, albedo_acc, ambient_acc, geo_shadow, t_s_acc, beta_acc,
                    mask, sc_pts, opacity, shadowless_rgb, entropy, after)


def _outputs(rgb, depth, albedo_acc, ambient_acc, geo_shadow, t_s_acc, beta_acc, mask,
             sc_pts, opacity, shadowless_rgb, entropy=None, opacity_after_surface=None):
    """The 13 outputs; entropy and the nadir diagnostics are ones when not
    computed, as in the JAX package."""
    ones = torch.ones_like(depth[:, None])
    return {
        "rgb": rgb,
        "depth": depth[:, None],
        "albedo_rgb": albedo_acc,
        "ambient_rgb": ambient_acc,
        "geo_shadows": geo_shadow,
        "transient_s": t_s_acc,
        "beta": beta_acc,
        "entropy": ones if entropy is None else entropy,
        "pts_per_ray": mask.sum(dim=-1).to(albedo_acc.dtype)[:, None],
        "sc_pts_per_ray": sc_pts,
        "opacity": opacity[:, None],
        "opacity_after_surface": (ones.expand(-1, 2).clone() if opacity_after_surface is None
                                  else opacity_after_surface),
        "shadowless_rgb": shadowless_rgb,
    }


def _render_rays_fused(field, rays: SatRays, cfg: RenderConfig, shadows: bool, generator,
                       occ_grid):
    """render_rays' fused branch: sampling and the per-ray composite stay in
    PyTorch, the per-sample work runs in the fused camera and shadow ops
    with per-ray input. Differentiable; nothing here writes in place into a
    tensor autograd needs."""
    d, sun_d = rays.viewdirs, rays.sundirs
    o = _corrected_origins(field, rays)
    near = rays.t_near
    r = o.shape[0]

    w = field.pack()
    z_mid, delta, pos, mask = _camera_samples(o, d, near, cfg, generator, field, occ_grid,
                                              weights=w)
    if occ_grid is not None and not cfg.occ_tighten:
        mask = mask & occ_grid.query(pos)
    deltam = set_last_valid(delta, mask, cfg.inf_delta) * mask
    emb = field.transient_embedding(rays.img_idx).to(o.dtype)
    rayin = torch.cat([o, d, emb, torch.zeros((r, 6), dtype=o.dtype, device=o.device)], dim=1)
    # the step-level saved-activations gate: both ops save, or neither
    # (KernelField.step_save_ok)
    save_ok = field.step_save_ok(r, z_mid.shape[1], (cfg.sc_n_samples - 1) if shadows else 0)
    acc = field.fused_camera(w, rayin.contiguous(), z_mid.contiguous(), deltam.contiguous(),
                             save_ok=save_ok)
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
        _, sc_z, sc_delta, sc_mask = _shadow_samples(sc_o.detach(), sc_d, torch.zeros_like(near),
                                                     cfg, generator, occ_grid)
        rayin_sc = torch.cat([sc_o, sc_d, torch.zeros((r, 10), dtype=o.dtype, device=o.device)],
                             dim=1)
        geo = field.fused_shadow(w, rayin_sc.contiguous(), sc_z.contiguous(),
                                 (sc_delta * sc_mask).contiguous(), sc_mask.float(),
                                 save_ok=save_ok)
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
    """Depth only, (R, 1) (reference sat_rendering.py:227-249), with the
    same sampling as ``render_rays`` (hierarchical, tightened): sigma-only
    per-sample passes, or the fused camera op's depth column on a
    kernel-backed field."""
    o = _corrected_origins(field, rays)
    fused = getattr(field, "supports_fused_render", False)
    w = field.pack() if fused else None
    z_mid, delta, pos, mask = _camera_samples(o, rays.viewdirs, rays.t_near, cfg, generator,
                                              field, occ_grid, weights=w)
    delta_cam = set_last_valid(delta, mask, cfg.inf_delta)
    if fused:
        r = o.shape[0]
        rayin = torch.cat([o, rays.viewdirs,
                           torch.zeros((r, 10), dtype=o.dtype, device=o.device)], dim=1)
        acc = field.fused_camera(w, rayin.contiguous(), z_mid.contiguous(),
                                 (delta_cam * mask).contiguous(),
                                 save_ok=field.step_save_ok(r, z_mid.shape[1]))
        return acc[:, 0:1]
    weights, _, _ = render_weights(field.density(pos), delta_cam, mask)
    return accumulate(weights, z_mid)[:, None]


@torch.no_grad()
def render_image(field, rays: SatRays, cfg: RenderConfig, shadows: bool, chunk: int = 4096,
                 generator=None, occ_grid=None, depth_only: bool = False):
    """Render any number of rays as a loop over ``chunk``-ray blocks (the
    last may be shorter); returns a dict of (N, ...) outputs, ``{"depth"}``
    alone with ``depth_only``. Peak memory is bounded by the chunk."""
    n = rays.origins.shape[0]
    outs = []
    for start in range(0, n, chunk):
        block = SatRays(*(x[start:start + chunk] for x in rays))
        if depth_only:
            outs.append({"depth": render_depth(field, block, cfg, generator, occ_grid)})
        else:
            outs.append(render_rays(field, block, cfg, shadows, generator, occ_grid))
    return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}


def _skip_blocks(field, rays: SatRays, cfg: RenderConfig, shadows, generator, occ_grid,
                 depth_only, n_blocks, chunk):
    """Advance ``generator`` past the draws of :func:`render_image`'s first
    ``n_blocks`` blocks of ``chunk`` rays: a one-ray render through a
    :class:`DrawLog` (on a generator of its own) gives the draws' shapes."""
    device = rays.origins.device
    log = DrawLog(torch.Generator(device=device))
    render_image(field, SatRays(*(x[:1] for x in rays)), cfg, shadows, chunk=1, generator=log,
                 occ_grid=occ_grid, depth_only=depth_only)
    for _ in range(n_blocks):
        skip_draws(log.draws, chunk, device, generator)


@torch.no_grad()
def render_image_sharded(field, rays: SatRays, cfg: RenderConfig, shadows: bool, mesh,
                         chunk: int = 4096, generator=None, occ_grid=None,
                         depth_only: bool = False):
    """:func:`render_image` over the ranks of ``mesh``'s data axis (the JAX
    package's ``render_image_sharded``): the ray count is padded to a
    multiple of ``chunk`` x world, each rank renders its contiguous run of
    ``chunk``-ray blocks (the padding is cut, not rendered: a run's blocks
    are ``render_image``'s own), and every rank returns the whole result
    (:meth:`Mesh.gather_rows`; the evaluation writes it on rank 0).

    The result is ``render_image``'s, bit for bit, for any ray count and
    any world. With ``cfg.perturb`` every block draws the numbers it draws
    in ``render_image`` from ``generator`` (the device's default when None):
    a rank first advances the generator past the draws of the blocks before
    its run (:func:`_skip_blocks`), so no two ranks replay one jitter and
    the eval does not depend on the number of ranks, as the JAX function's
    one key a global block makes it."""
    n = rays.origins.shape[0]
    per_rank = -(-n // (chunk * mesh.world)) * chunk
    start = mesh.rank * per_rank
    stop = min(start + per_rank, n)
    if cfg.perturb and 0 < start < n:
        _skip_blocks(field, rays, cfg, shadows, generator, occ_grid, depth_only,
                     start // chunk, chunk)
    # a rank whose run is all padding renders the last ray alone, for the
    # outputs' shapes, and contributes no row
    block = SatRays(*(x[start:stop] if stop > start else x[n - 1:] for x in rays))
    out = render_image(field, block, cfg, shadows, chunk=chunk, generator=generator,
                       occ_grid=occ_grid, depth_only=depth_only)
    local = {k: v[:max(stop - start, 0)] for k, v in out.items()}
    return mesh.gather_rows(local, start, n)
