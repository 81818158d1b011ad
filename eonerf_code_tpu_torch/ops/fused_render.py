"""Fused render ops: field evaluation + volume compositing with per-ray
input and output, forward and backward.

- ``camera_forward(weights, rayin, z, deltam) -> acc (R, 8)`` =
  [depth, albedo r g b, t_s, t_beta, opacity, 0]: the counterpart of the JAX
  package's ``make_fused_camera`` forward (its ``_camera_fwd_kernel``).
- ``shadow_forward(weights, rayin, z, deltam, mask) -> geo (R,)``: the sun
  visibility of the geometric shadow pass, counterpart of
  ``make_fused_shadow`` (``_shadow_fwd_kernel``).
- ``coarse_forward(weights, rayin, z, deltam) -> w (R, K)``: the
  per-sample compositing weights of a density-only pass, the PDF the
  hierarchical sampler draws from; counterpart of ``make_fused_coarse``
  (``_coarse_fwd_kernel``). Forward only.
- ``camera_backward`` / ``shadow_backward``: their VJPs (the JAX package's
  ``_camera_bwd_kernel`` / ``_shadow_bwd_kernel``), recomputing the
  forward; float32 weight gradients in the packed layout and per-ray
  d_rayin = [d_o, d_d, d_emb, 0].
- ``fused_camera`` / ``fused_shadow``: the pairs as
  ``torch.autograd.Function``s (the JAX package's ``custom_vjp`` ops);
  ``fused_coarse``: the coarse op on detached inputs, as the JAX package's
  ``stop_gradient`` wrapper.

The saved-activations mode (the JAX package's ``save_acts``, its default
``bwd_acts="saved"``): ``camera_forward_save`` / ``shadow_forward_save``
also return the trunk's activations, which ``camera_backward_saved`` /
``shadow_backward_saved`` read in place of the recompute; ``fused_camera``
and ``fused_shadow`` take ``save``, and ``saved_stream_bytes`` /
``fits_saved_cap`` are the JAX package's gate.

The int8 trunk tier (the JAX package's ``trunk_quant`` True and "full"):
given ``q8`` (:class:`Q8Weights`) the ops run the trunk in int8 with one
activation scale per group of ``rt_of(KPAD, target, R)`` rays x KPAD rows
(targets 2048 forward, 1024 backward), the call padded with zero rays to
whole groups; ``camera_forward_q8``, ``shadow_forward_q8``,
``coarse_forward_q8``, ``camera_backward_q8`` / ``_q8_full`` and
``shadow_backward_q8`` / ``_q8_full`` are their wrappers, and
``fused_camera``, ``fused_shadow`` and ``fused_coarse`` take
``trunk_quant``.

``rayin`` rows are [origin(3), direction(3), embedding(4), 0*6]; ``deltam``
is delta * valid_mask with the camera pass's 1e10 last-valid sentinel
already applied. The sample axis is padded to KPAD = round8(K) with z = 0
and deltam = 0, which adds no extinction.

Each op is a wrapper beside its plain PyTorch version
(``*_reference``, the same arithmetic, used by the tests and as the
kernels' yardstick on the card). The wrapper takes the plain version only
for tensors on the CPU; for CUDA tensors it launches the hand-written
kernel (csrc/fused_render.cu) or raises. Each wrapper counts its kernel
launches in its ``launches`` attribute.
"""

import ctypes
import math

import torch
import torch.nn.functional as F

from eonerf_code_tpu_torch.ops import _build
from eonerf_code_tpu_torch.ops.fused_field import (
    BIAS_ELEMENTS,
    MAT_ELEMENTS,
    PE_PAD,
    Q8_POINTS,
    STREAM_CHUNK_BYTES,
    STREAM_CHUNKS,
    STREAM_MAX_BLOCKS,
    TILE_ROWS,
    TRUNK_MAT_ELEMENTS,
    KernelWeights,
    _MAT_SHAPES,
    Q8Weights,
    check_f32,
    check_weights,
    emb_block,
    heads,
    heads_backward,
    kernel_views,
    launch,
    mm,
    pack_grads,
    pe_deriv,
    pe_from_args,
    pe_lanes,
    pe_pattern,
    quantize_kernel_trunk,
    sigma_backward,
    softplus,
    trunk,
    trunk_backward,
    trunk_backward_q8,
    trunk_q8,
)
from eonerf_code_tpu_torch.ops.volrend import exclusive_cumsum

RAYIN_COLS = 16   # [o(3), d(3), emb(4), pad(6)]
ACC_COLS = 8      # [depth, albedo r g b, t_s, t_beta, opacity, pad]
MAX_KPAD = 1024   # the kernels keep every sample of a ray's results in shared memory


# ---------------------------------------------------------------------------
# the int8 tier's scale groups
# ---------------------------------------------------------------------------

def kpad_of(k):
    """Samples padded to a multiple of 8 (the kernels' tile rows)."""
    return ((max(k, 1) + 7) // 8) * 8


def rt_of(kpad, target, n_rays):
    """Rays per scale group of the int8 tier: about ``target`` rows, a
    multiple of 8 rays, never more than the call's rays rounded up to 8 (the
    JAX package's rays per Pallas tile, whose block is the group)."""
    rt = max((target // kpad) // 8 * 8, 8)
    return min(rt, ((n_rays + 7) // 8) * 8)


def q8_plan(r, k, target):
    """(KPAD, rays per group, padded ray count) of an int8 call of r rays of
    k samples: the call is padded with zero rays to whole groups."""
    kpad = kpad_of(k)
    rt = rt_of(kpad, target, r)
    return kpad, rt, -(-r // rt) * rt


Q8_CLUSTER_MAX = 16   # CTAs a cluster of the int8 trunk's cluster kernel
Q8_CTA_ROWS = 128     # rows of one of its CTAs
Q8_TRUNK_PATHS = ("layer_major", "cluster")   # the C library's path numbers 0, 1
# act_stream_cols' widths (camera, shadow), for the plain version of q8_trunk
PLAIN_STREAM_COLS = {True: 3072, False: 2112}


def q8_trunk_plan(kpad, group_rows):
    """How the kernels run the int8 trunk for scale groups of ``group_rows``
    rows of ``kpad`` samples, mirroring csrc/fused_render.cu's ``q8_path``:
    ``(path, cluster CTAs, rows of a group's last CTA)``. "cluster" (one
    launch, a thread-block cluster a group, CTA ``rank`` holding rows
    ``128 rank ..``) when the group is whole 64-row slabs over at most 16
    CTAs of 128 rows, else "layer_major" (a launch a layer); the CTA count
    is the group's either way."""
    if kpad <= 0 or kpad % 8 or kpad > MAX_KPAD or group_rows <= 0 or group_rows % kpad:
        raise ValueError(f"no int8 call has groups of {group_rows} rows of {kpad} samples")
    ctas = -(-group_rows // Q8_CTA_ROWS)
    cluster = group_rows % 64 == 0 and ctas <= Q8_CLUSTER_MAX
    return ("cluster" if cluster else "layer_major", ctas,
            group_rows - Q8_CTA_ROWS * (ctas - 1))


def _pad_call(rp, kpad, per_ray, per_sample):
    """Rows padded with zeros to rp rays, samples to kpad (z = 0, deltam =
    0, mask = 0: padded samples add no extinction; zero rays and padded
    samples still run the trunk and count in their group's scales)."""
    return ([F.pad(x, (0, 0, 0, rp - x.shape[0])) for x in per_ray],
            [F.pad(x, (0, kpad - x.shape[1], 0, rp - x.shape[0])) for x in per_sample])


def _keep(stats, **tensors):
    if stats is not None:
        stats.update(tensors)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _pe_args(rayin, z):
    """(R, K, 64) PE arguments xb = o B + (d B) z in float32 (exact for the
    power-of-two B: one nonzero term per lane)."""
    j, scale = pe_lanes(rayin.device)
    basis_o = rayin[:, 0:3][:, j] * scale
    basis_d = rayin[:, 3:6][:, j] * scale
    return basis_o[:, None, :] + basis_d[:, None, :] * z[:, :, None]


def _pe(rayin, z, dtype):
    return pe_from_args(_pe_args(rayin, z), dtype)


def _emb64(rayin, r, k):
    return emb_block(rayin[:, 6:10])[:, None, :].expand(r, k, PE_PAD).reshape(-1, PE_PAD)


def _trunk_of(pe, w, dtype, q8, group_rows):
    """(activations, masks, group amax or None): the bf16 trunk, or with
    ``q8`` the int8 trunk in groups of ``group_rows`` rows."""
    if q8 is None:
        return (*trunk(pe, w, dtype), None)
    return trunk_q8(pe, w, q8, dtype, group_rows)


def _inputs(rayin, per_sample, q8, target, per_ray=()):
    """float32 inputs; with ``q8``, padded to whole scale groups. Returns
    (rayin, per-ray tensors, per-sample tensors, rows per group or None)."""
    rayin, per_ray = rayin.float(), [x.float() for x in per_ray]
    per_sample = [x.float() for x in per_sample]
    if q8 is None:
        return rayin, per_ray, per_sample, None
    kpad, rt, rp = q8_plan(rayin.shape[0], per_sample[0].shape[1], target)
    (rayin, *per_ray), per_sample = _pad_call(rp, kpad, [rayin, *per_ray], per_sample)
    return rayin, per_ray, per_sample, rt * kpad


def camera_forward_reference(weights: KernelWeights, rayin, z, deltam, q8=None,
                             tile_target=2048, stats=None, save=False):
    """Plain PyTorch version of :func:`camera_forward` (any K, no padding
    needed: padded samples add nothing). With ``q8`` the trunk runs int8 in
    scale groups of about ``tile_target`` rows (the call padded to whole
    groups); ``stats`` (a dict) then receives the group amax (G, 8). With
    ``save`` (the compute dtype's trunk only) returns (acc, acts): acts
    (R*K, 2048) are the post-ReLU h0..h7 of every sample in the compute
    dtype, the JAX package's saved stream, which
    :func:`camera_backward_reference` takes as ``acts``."""
    dtype = weights.dtype
    w = kernel_views(weights)
    n = z.shape[0]
    rayin, _, (z, deltam), gr = _inputs(rayin, (z, deltam), q8, tile_target)
    r, k = z.shape
    if save and q8 is not None:
        raise ValueError("the saved activations are never combined with the int8 trunk")
    acts, _, amax = _trunk_of(_pe(rayin, z, dtype), w, dtype, q8, gr)
    sigma, albedo, ts, tb, _ = heads(acts[-1], _emb64(rayin, r, k), w, dtype)
    sdelta = sigma.view(r, k) * deltam
    weights_rk = torch.exp(-exclusive_cumsum(sdelta)) * (1.0 - torch.exp(-sdelta))
    values = torch.cat([z[..., None], albedo.view(r, k, 3), ts.view(r, k, 1),
                        tb.view(r, k, 1), torch.ones_like(z)[..., None],
                        torch.zeros_like(z)[..., None]], dim=-1)
    _keep(stats, amax=amax)
    acc = (weights_rk[..., None] * values).sum(dim=1)[:n]
    return (acc, torch.cat(acts, dim=1)) if save else acc


def _sigma_of(rayin, z, w, dtype, q8, group_rows):
    acts, _, amax = _trunk_of(_pe(rayin, z, dtype), w, dtype, q8, group_rows)
    return softplus(mm(acts[-1], w.sigma_w, w.sigma_b)).view(z.shape), amax, acts


def shadow_forward_reference(weights: KernelWeights, rayin, z, deltam, mask, q8=None,
                             tile_target=2048, stats=None, save=False):
    """Plain PyTorch version of :func:`shadow_forward`; ``q8``, ``tile_target``,
    ``stats`` and ``save`` as in :func:`camera_forward_reference`."""
    dtype = weights.dtype
    n = z.shape[0]
    rayin, _, (z, deltam, mask), gr = _inputs(rayin, (z, deltam, mask), q8, tile_target)
    if save and q8 is not None:
        raise ValueError("the saved activations are never combined with the int8 trunk")
    sigma, amax, acts = _sigma_of(rayin, z, kernel_views(weights), dtype, q8, gr)
    _keep(stats, amax=amax)
    geo = torch.exp(-(sigma * deltam * _before_last(mask)).sum(dim=-1))[:n]
    return (geo, torch.cat(acts, dim=1)) if save else geo


def coarse_forward_reference(weights: KernelWeights, rayin, z, deltam, q8=None,
                             tile_target=2048, stats=None):
    """Plain PyTorch version of :func:`coarse_forward`: the density trunk and
    the per-sample weights T_i (1 - e^(-sigma_i deltam_i)) with the
    EXCLUSIVE transmittance T_i, as ``render_weights``; ``q8``,
    ``tile_target`` and ``stats`` as in :func:`camera_forward_reference`."""
    dtype = weights.dtype
    n, k = z.shape
    rayin, _, (z, deltam), gr = _inputs(rayin, (z, deltam), q8, tile_target)
    sigma, amax, _ = _sigma_of(rayin, z, kernel_views(weights), dtype, q8, gr)
    sdelta = sigma * deltam
    _keep(stats, amax=amax)
    return (torch.exp(-exclusive_cumsum(sdelta)) * (1.0 - torch.exp(-sdelta)))[:n, :k]


def _before_last(mask):
    """1 where a sample lies strictly before its ray's last valid one: the
    count of valid samples from it on (reverse inclusive) is >= 2."""
    remaining = mask.float().flip(-1).cumsum(-1).flip(-1)
    return (remaining >= 2.0).float()


def _reverse_exclusive_cumsum(x):
    """out_i = sum_{j>i} x_j, shifting first (never inclusive minus self)."""
    return exclusive_cumsum(x.flip(-1)).flip(-1)


def _ray_grads(xb, z, g_pe, dtype, r, k):
    """Per-ray d_o, d_d (R, 3) from the PE cotangent: d_xb = g_pe * pe'(xb),
    summed over the ray's samples, routed through the transposed B."""
    d_xb = (g_pe.float() * pe_deriv(xb, dtype)).view(r, k, PE_PAD)
    pat = pe_pattern(xb.device)
    return d_xb.sum(dim=1) @ pat.t(), (d_xb * z[..., None]).sum(dim=1) @ pat.t()


def _trunk_or_saved(pe, w, dtype, q8, group_rows, acts):
    """The trunk's (activations, masks, group amax): recomputed, or split
    from the saved (M, 2048) stream ``acts`` (never with ``q8``) with the
    masks from the post-ReLU values (h > 0 iff its pre-activation was), as
    the JAX package's ``_masks_from_acts``."""
    if acts is None:
        return _trunk_of(pe, w, dtype, q8, group_rows)
    if q8 is not None:
        raise ValueError("the saved activations are never combined with the int8 trunk")
    hs = list(acts.split(256, dim=1))
    return hs, [(h.float() > 0).to(dtype) for h in hs], None


def camera_backward_reference(weights: KernelWeights, rayin, z, deltam, gacc, q8=None,
                              full=False, tile_target=1024, stats=None, acts=None):
    """Plain PyTorch version of :func:`camera_backward`: the VJP of the
    camera op for the per-ray cotangent ``gacc`` (R, 8), recomputing the
    forward. Mirrors the JAX package's ``_camera_bwd_kernel`` step by step
    at its rounding points. Returns (d_mats, d_biases) in the packed
    layout, float32, and d_rayin (R, 16) = [d_o, d_d, d_emb, 0].

    With ``q8`` the recompute runs the int8 trunk in the backward's scale
    groups (about ``tile_target`` rows); the trunk's dgrad and wgrad then run
    in the compute dtype against the unquantized weights (``int8``,
    straight-through), or with ``full`` in int8 (``int8_full``). ``stats``
    receives the recompute's group amax and, with ``full``, the cotangents'
    (``gamax``). With ``acts`` (the saved (R*K, 2048) stream of
    ``camera_forward_reference(..., save=True)``) the trunk is read from it
    in place of the recompute; the PE is recomputed, as in the JAX
    package's saved backward."""
    dtype = weights.dtype
    w = kernel_views(weights)
    n = z.shape[0]
    rayin, (gacc,), (z, deltam), gr = _inputs(rayin, (z, deltam), q8, tile_target, (gacc,))
    r, k = z.shape
    xb = _pe_args(rayin, z)
    pe = pe_from_args(xb, dtype)
    acts, masks, amax = _trunk_or_saved(pe, w, dtype, q8, gr, acts)
    h = acts[-1]
    sigma, albedo, ts, tb, res = heads(h, _emb64(rayin, r, k), w, dtype)

    # compositing backward (f32)
    sdelta = sigma.view(r, k) * deltam
    trans = torch.exp(-exclusive_cumsum(sdelta))
    em = torch.exp(-sdelta)
    alpha = 1.0 - em
    w_rk = trans * alpha
    v_raw = torch.cat([z[..., None], albedo.view(r, k, 3), ts.view(r, k, 1), tb.view(r, k, 1),
                       torch.ones_like(z)[..., None], torch.zeros_like(z)[..., None]], dim=-1)
    d_w = (gacc[:, None, :] * v_raw).sum(dim=-1)
    d_val = (gacc[:, None, :] * w_rk[..., None]).reshape(-1, ACC_COLS)
    d_alpha = d_w * trans
    d_excl = -trans * (d_w * alpha)
    d_sdelta = d_alpha * em + _reverse_exclusive_cumsum(d_excl)
    d_sigma = (d_sdelta * deltam).reshape(-1, 1)

    g = [None] * 36
    g_h, g_emb = heads_backward(h, res, d_sigma, d_val, w, dtype, g)
    g_pe = _trunk_grads(pe, acts, masks, g_h, w, dtype, g, q8, full, gr, stats)
    _keep(stats, amax=amax)
    d_o, d_d = _ray_grads(xb, z, g_pe, dtype, r, k)
    d_emb = g_emb.view(r, k, 4).sum(dim=1)
    d_rayin = torch.cat([d_o, d_d, d_emb, torch.zeros((r, RAYIN_COLS - 10), device=z.device)],
                        dim=1)
    return (*pack_grads(g), d_rayin[:n])


def _trunk_grads(pe, acts, masks, g_h, w, dtype, g, q8, full, group_rows, stats):
    """The trunk's backward: int8 with ``full`` (keeping the cotangents'
    group amax in ``stats``), else in the compute dtype."""
    if not full:
        return trunk_backward(pe, acts, masks, g_h, w, dtype, g)
    g_pe, gamax = trunk_backward_q8(pe, acts, masks, g_h, q8, dtype, g, group_rows)
    _keep(stats, gamax=gamax)
    return g_pe


def shadow_backward_reference(weights: KernelWeights, rayin, z, deltam, mask, ggeo, q8=None,
                              full=False, tile_target=1024, stats=None, acts=None):
    """Plain PyTorch version of :func:`shadow_backward`: the VJP of the
    shadow op for the per-ray cotangent ``ggeo`` (R,), mirroring the JAX
    package's ``_shadow_bwd_kernel``. Returns (d_mats, d_biases) in the
    packed layout, float32, zero past the density prefix (the heads get
    exact zeros), and d_rayin (R, 16) = [d_o, d_d, 0]. ``q8``, ``full``,
    ``tile_target``, ``stats`` and ``acts`` as in
    :func:`camera_backward_reference`."""
    dtype = weights.dtype
    w = kernel_views(weights)
    n = z.shape[0]
    rayin, (ggeo,), (z, deltam, mask), gr = _inputs(rayin, (z, deltam, mask), q8, tile_target,
                                                    (ggeo.reshape(-1, 1),))
    r, k = z.shape
    xb = _pe_args(rayin, z)
    pe = pe_from_args(xb, dtype)
    acts, masks, amax = _trunk_or_saved(pe, w, dtype, q8, gr, acts)
    sig_pre = mm(acts[-1], w.sigma_w, w.sigma_b)
    before_last = _before_last(mask)
    geo = torch.exp(-(softplus(sig_pre).view(r, k) * deltam * before_last).sum(dim=-1))
    d_ev = -geo * ggeo.reshape(-1)
    d_sigma = (d_ev[:, None] * before_last * deltam).reshape(-1, 1)
    g, g_pe = sigma_backward(
        pe, acts, masks, sig_pre, d_sigma, w, dtype,
        lambda g_h, g: _trunk_grads(pe, acts, masks, g_h, w, dtype, g, q8, full, gr, stats))
    _keep(stats, amax=amax)
    d_o, d_d = _ray_grads(xb, z, g_pe, dtype, r, k)
    d_rayin = torch.cat([d_o, d_d, torch.zeros((r, RAYIN_COLS - 6), device=z.device)], dim=1)
    return (*pack_grads(g), d_rayin[:n])


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _padded(x, kpad):
    return F.pad(x, (0, kpad - x.shape[1])).contiguous()


def _check_call(weights, rayin, z, *named):
    """The bf16 wrappers' checks: rayin (R, 16), z (R, K) and each (name,
    tensor, shape) of ``named`` float32 and contiguous on rayin's device,
    the packed weights, and K within the kernels' limit. Returns
    (R, KPAD)."""
    r, k = z.shape
    dev = rayin.device
    check_f32("rayin", rayin, (r, RAYIN_COLS), dev)
    check_f32("z", z, (r, k), dev)
    for name, t, shape in named:
        check_f32(name, t, shape, dev)
    check_weights(weights, dev)
    kpad = kpad_of(k)
    if kpad > MAX_KPAD:
        raise ValueError(f"{k} samples per ray exceed the kernel's {MAX_KPAD}")
    return r, kpad


def _zero_grads(r, dev):
    """(d_mats, d_biases, d_rayin) float32 zeros for a backward of r rays."""
    return (torch.zeros((MAT_ELEMENTS,), dtype=torch.float32, device=dev),
            torch.zeros((BIAS_ELEMENTS,), dtype=torch.float32, device=dev),
            torch.zeros((r, RAYIN_COLS), dtype=torch.float32, device=dev))


def camera_forward(weights: KernelWeights, rayin, z, deltam, q8=None, tile_target=2048,
                   stats=None):
    """Per-ray camera accumulators (R, 8) for rays (R, 16), z and deltam
    (R, K). CPU tensors: the plain version. CUDA tensors: the hand-written
    bf16 kernel, stream_fwd_kernel over the samples with deltam != 0
    (:func:`stream_fwd_plan`; raises if it cannot be built or launched); with
    ``q8`` (Q8Weights) the int8 trunk's kernels, :func:`camera_forward_q8`."""
    if q8 is not None:
        return camera_forward_q8(weights, q8, rayin, z, deltam, tile_target, stats)
    if rayin.device.type == "cpu":
        return camera_forward_reference(weights, rayin, z, deltam)
    r, kpad = _check_call(weights, rayin, z, ("deltam", deltam, z.shape))
    acc = torch.empty((r, ACC_COLS), dtype=torch.float32, device=rayin.device)
    if r == 0:
        return acc
    launch("eonerf_camera_fwd", "camera_forward kernel launch", rayin.device, rayin,
           _padded(z, kpad), _padded(deltam, kpad), weights.mats, weights.biases, acc, r, kpad,
           after_stream=(_stream_workspace(True, r, kpad, rayin.device).data_ptr(),))
    camera_forward.launches += 1
    return acc


camera_forward.launches = 0


def shadow_forward(weights: KernelWeights, rayin, z, deltam, mask, q8=None, tile_target=2048,
                   stats=None):
    """Per-ray sun visibility (R,) for shadow rays (R, 16), z, deltam and
    the float 0/1 validity mask (R, K). CPU tensors: the plain version. CUDA
    tensors: the hand-written bf16 kernel (raises if it cannot run); with
    ``q8`` :func:`shadow_forward_q8`."""
    if q8 is not None:
        return shadow_forward_q8(weights, q8, rayin, z, deltam, mask, tile_target, stats)
    if rayin.device.type == "cpu":
        return shadow_forward_reference(weights, rayin, z, deltam, mask)
    r, kpad = _check_call(weights, rayin, z, ("deltam", deltam, z.shape), ("mask", mask, z.shape))
    geo = torch.empty((r,), dtype=torch.float32, device=rayin.device)
    if r == 0:
        return geo
    launch("eonerf_shadow_fwd", "shadow_forward kernel launch", rayin.device, rayin,
           _padded(z, kpad), _padded(deltam, kpad), _padded(mask, kpad), weights.mats,
           weights.biases, geo, r, kpad,
           after_stream=(_stream_workspace(False, r, kpad, rayin.device).data_ptr(),))
    shadow_forward.launches += 1
    return geo


shadow_forward.launches = 0


def coarse_forward(weights: KernelWeights, rayin, z, deltam, q8=None, tile_target=2048,
                   stats=None):
    """Per-sample compositing weights (R, K) of the density field for rays
    (R, 16), z and deltam (R, K). CPU tensors: the plain version. CUDA
    tensors: the hand-written bf16 kernel (raises if it cannot run); with
    ``q8`` :func:`coarse_forward_q8`."""
    if q8 is not None:
        return coarse_forward_q8(weights, q8, rayin, z, deltam, tile_target, stats)
    if rayin.device.type == "cpu":
        return coarse_forward_reference(weights, rayin, z, deltam)
    r, kpad = _check_call(weights, rayin, z, ("deltam", deltam, z.shape))
    out = torch.empty((r, kpad), dtype=torch.float32, device=rayin.device)
    if r == 0:
        return out[:, :z.shape[1]]
    launch("eonerf_coarse_fwd", "coarse_forward kernel launch", rayin.device, rayin,
           _padded(z, kpad), _padded(deltam, kpad), weights.mats, weights.biases, out, r, kpad,
           after_stream=(_stream_workspace(False, r, kpad, rayin.device).data_ptr(),))
    coarse_forward.launches += 1
    return out[:, :z.shape[1]]


coarse_forward.launches = 0


# ---------------------------------------------------------------------------
# the plain forwards' plan (csrc/fused_render.cu stream_fwd_kernel)
# ---------------------------------------------------------------------------



def stream_fwd_layout(camera, r, kpad):
    """Byte offsets of a plain forward's workspace (the library's
    fs_layout; C entry ``eonerf_stream_fwd_layout``): the weight stream,
    each row's results (camera: 8 floats, else 1) and its (ray, sample), the
    rays' counts, their prefix, the blocks' first rays, then ``total``; each
    part rounded up to 256 bytes."""
    rows = r * kpad
    parts = (("stream", STREAM_CHUNKS[camera] * STREAM_CHUNK_BYTES),
             ("res", rows * (8 if camera else 1) * 4), ("meta", rows * 8), ("cnt", r * 4),
             ("prefix", (r + 1) * 4), ("ray_start", (STREAM_MAX_BLOCKS + 1) * 4))
    out, off = {}, 0
    for name, nbytes in parts:
        out[name] = off
        off += -(-nbytes // 256) * 256
    out["total"] = off
    return out


def _stream_workspace(camera, r, kpad, dev):
    return torch.empty((stream_fwd_layout(camera, r, kpad)["total"],), dtype=torch.uint8,
                       device=dev)


def stream_fwd_plan(deltam, blocks):
    """How the plain forwards (the camera, shadow and coarse kernels) cover
    rays of per-sample ``deltam`` (R, KPAD) on a grid of ``blocks`` (the
    card's SMs, C entry ``eonerf_stream_fwd_grid``), as the library's plan
    kernels do. Only the samples with deltam != 0 are rows: a ray's in
    sample order, after the rows of the rays before it. Returns int64
    tensors: ``counts`` (R,); ``prefix`` (R + 1,), a ray's first row (the
    total last); ``ray_start`` (blocks + 1,): block b owns rays
    ray_start[b] .. ray_start[b + 1] - 1, the first of them the first ray
    whose first row is at or past b * ceil(rows / blocks) (R if none);
    ``rows`` and ``tiles`` (blocks,): its rows and 128-row tiles (a ray may
    straddle its tiles); ``meta`` (rows, 2): each row's (ray, sample)."""
    nz = deltam != 0
    r = deltam.shape[0]
    counts = nz.sum(dim=1).long()
    prefix = torch.cat([torch.zeros((1,), dtype=torch.long), counts.cumsum(0)])
    total = int(prefix[-1])
    target = max(1, -(-total // blocks))
    ray_start = torch.searchsorted(prefix, torch.arange(blocks + 1) * target).clamp(max=r)
    ray_start[-1] = r
    rows = prefix[ray_start[1:]] - prefix[ray_start[:-1]]
    return {"counts": counts, "prefix": prefix, "ray_start": ray_start, "rows": rows,
            "tiles": -(-rows // TILE_ROWS), "meta": nz.nonzero()}


def _stream_sources(mats, camera):
    """(wide, (n_out, k_dim) matrix) of each layer of the weight stream, in
    its order: the trunk's eight, then (camera) the bottleneck, [albedo
    hidden | transient 0] (the albedo rows zero past their 256 inputs) and
    transient 1..3; mats the packed (out, in) matrices."""
    views, off = [], 0
    for n_in, n_out in _MAT_SHAPES:
        views.append(mats[off:off + n_in * n_out].view(n_out, n_in))
        off += n_in * n_out
    layers = [(True, v) for v in views[:8]]
    if camera:
        alb0 = F.pad(views[10], (0, views[12].shape[1] - views[10].shape[1]))
        layers += [(True, views[9]), (True, torch.cat([alb0, views[12]])),
                   *((False, v) for v in views[13:16])]
    return layers


def stream_fwd_weights(mats, camera):
    """The weight stream the plain forwards' plan writes (STREAM_CHUNKS
    chunks of 8192 bf16), as the ring stages hold it: chunk halves of 128
    (n, k) rows, 32 deep, unit u (8 values) of row n at u ^ ((n >> 1) & 3);
    a wide layer's chunk is a 32-deep k slice, its halves output rows 0..127
    and 128..255; a narrow one's a 64-deep slice, its halves the two 32-deep
    parts."""
    n = torch.arange(128)
    unit = torch.arange(4)[None, :] ^ ((n[:, None] >> 1) & 3)   # stored unit -> its k unit
    chunks = []
    for wide, m in _stream_sources(mats, camera):
        k = m.shape[1]
        if wide:   # (halves, rows, k slices, units, 8) -> (slice, half, rows, ...)
            b = m.reshape(2, 128, k // 32, 4, 8).permute(2, 0, 1, 3, 4)
        else:      # (rows, k slices, halves, units, 8) -> (slice, half, rows, ...)
            b = m.reshape(128, k // 64, 2, 4, 8).permute(1, 2, 0, 3, 4)
        chunks.append(b[:, :, n[:, None], unit, :].reshape(-1, 8192))
    return torch.cat(chunks)


def stream_fwd_kernel_launches():
    """Launches of stream_fwd_kernel the library has made so far, by mode:
    {"camera", "shadow", "coarse"} (C entry ``eonerf_stream_fwd_launches``)."""
    count = (ctypes.c_longlong * 3)()
    _build.load_library().eonerf_stream_fwd_launches(count)
    return dict(zip(("camera", "shadow", "coarse"), (int(c) for c in count)))


def _workspace(camera, r, kpad, dev, saved=False):
    """The backward kernels' scratch (activations, unless ``saved``;
    cotangents and the partial sums of the fixed-order gradient reduction),
    sized by the library itself."""
    lib = _build.load_library()
    size = lib.eonerf_saved_bwd_workspace_bytes if saved else lib.eonerf_bwd_workspace_bytes
    return torch.empty((size(int(camera), r, kpad),), dtype=torch.uint8, device=dev)



def rays_per_unit(kpad):
    """Rays in one unit of the kernels' work (rays_per_block of
    csrc/fused_render.cu): as many whole rays as fill 128-row tiles exactly
    (KPAD 96: 4 rays in 3 tiles; 144: 8 in 9), unless that is more than
    1280 samples; then as many as one tile holds, at least one. Points
    (kpad 1): 128."""
    fill = 128 // math.gcd(128, kpad)
    if fill * kpad <= 1280:
        return fill
    return 1 if kpad >= 128 else 128 // kpad


def dgrad_plan(r, kpad, sms):
    """How the dgrad kernel (the second launch of every bf16 backward)
    covers r rays of kpad samples (or r points, kpad 1) on a card of ``sms``
    SMs, as the library plans it (C entry ``eonerf_dgrad_plan``): (rays a
    unit, units, blocks). Each unit has its row of bias partial sums in the
    workspace (reduced in unit order); the persistent grid's block b walks
    units b, b + blocks, ..., a unit's samples in 128-row tiles."""
    rpb = rays_per_unit(kpad)
    units = -(-r // rpb)
    return rpb, units, min(units, sms)


def dgrad_block_tiles(r, kpad, sms):
    """[(unit, first sample row of the unit, rows)] of the tiles each block
    of the dgrad kernel's grid works on, in its order (:func:`dgrad_plan`)."""
    rpb, units, blocks = dgrad_plan(r, kpad, sms)
    out = []
    for b in range(blocks):
        tiles = []
        for u in range(b, units, blocks):
            rows = min(rpb, r - u * rpb) * kpad
            tiles += [(u, s0, min(128, rows - s0)) for s0 in range(0, rows, 128)]
        out.append(tiles)
    return out


def dgrad_kernel_launches():
    """Launches of the dgrad kernel that the library has made so far, every
    instantiation (camera, shadow, field, density, heads-only): counted in
    csrc/fused_render.cu where it launches it, whichever wrapper called."""
    count = (ctypes.c_longlong * 1)()
    _build.load_library().eonerf_dgrad_launches(count)
    return int(count[0])


def dgrad_library_plan(r, kpad):
    """The library's own dgrad plan on the current card: (rays a unit,
    units, blocks, shared memory bytes)."""
    out = (ctypes.c_longlong * 4)()
    _build.load_library().eonerf_dgrad_plan(r, kpad, out)
    return tuple(int(v) for v in out)

def camera_backward(weights: KernelWeights, rayin, z, deltam, gacc, q8=None, full=False,
                    tile_target=1024, stats=None):
    """VJP of :func:`camera_forward` for the per-ray cotangent ``gacc``
    (R, 8): (d_mats, d_biases) float32 in the packed layout and d_rayin
    (R, 16). CPU tensors: the plain version. CUDA tensors: the hand-written
    bf16 kernels (raises if they cannot be built or launched); with ``q8``
    the int8 tier's, :func:`camera_backward_q8` (``full``:
    :func:`camera_backward_q8_full`)."""
    if q8 is not None:
        op = camera_backward_q8_full if full else camera_backward_q8
        return op(weights, q8, rayin, z, deltam, gacc, tile_target, stats)
    if rayin.device.type == "cpu":
        return camera_backward_reference(weights, rayin, z, deltam, gacc)
    r, kpad = _check_call(weights, rayin, z, ("deltam", deltam, z.shape),
                          ("gacc", gacc, (z.shape[0], ACC_COLS)))
    dev = rayin.device
    grads = _zero_grads(r, dev)
    if r == 0:
        return grads
    launch("eonerf_camera_bwd", "camera_backward kernel launch", dev, rayin, _padded(z, kpad),
           _padded(deltam, kpad), gacc, weights.mats, weights.biases,
           _workspace(True, r, kpad, dev), *grads, r, kpad)
    camera_backward.launches += 1
    return grads


camera_backward.launches = 0


def shadow_backward(weights: KernelWeights, rayin, z, deltam, mask, ggeo, q8=None, full=False,
                    tile_target=1024, stats=None):
    """VJP of :func:`shadow_forward` for the per-ray cotangent ``ggeo``
    (R,): (d_mats, d_biases) float32 in the packed layout (zero past the
    density prefix) and d_rayin (R, 16). CPU tensors: the plain version.
    CUDA tensors: the hand-written bf16 kernels (raises if they cannot
    run); with ``q8`` :func:`shadow_backward_q8` (``full``:
    :func:`shadow_backward_q8_full`)."""
    if q8 is not None:
        op = shadow_backward_q8_full if full else shadow_backward_q8
        return op(weights, q8, rayin, z, deltam, mask, ggeo, tile_target, stats)
    if rayin.device.type == "cpu":
        return shadow_backward_reference(weights, rayin, z, deltam, mask, ggeo)
    r, kpad = _check_call(weights, rayin, z, ("deltam", deltam, z.shape), ("mask", mask, z.shape),
                          ("ggeo", ggeo, (z.shape[0],)))
    dev = rayin.device
    grads = _zero_grads(r, dev)
    if r == 0:
        return grads
    launch("eonerf_shadow_bwd", "shadow_backward kernel launch", dev, rayin, _padded(z, kpad),
           _padded(deltam, kpad), _padded(mask, kpad), ggeo, weights.mats, weights.biases,
           _workspace(False, r, kpad, dev), *grads, r, kpad)
    shadow_backward.launches += 1
    return grads


shadow_backward.launches = 0


# ---------------------------------------------------------------------------
# the saved-activations mode: the forward keeps the trunk's activations, the
# backward reads them in place of the recompute
# ---------------------------------------------------------------------------

N_TRUNK_ACTS_COLS = 8 * 256   # the JAX package's saved stream: h0..h7


def saved_stream_bytes(r, k, compute_dtype):
    """Device bytes one saved stream (camera or shadow) holds from forward
    to backward for R rays x K samples, by the JAX package's formula
    (R x KPAD x 2048 x itemsize). The port's kernels keep wider rows
    (:func:`act_stream_cols`: the PE, and for the camera the heads, beside
    h0..h7); the gate keeps the JAX formula so that both packages save on
    the same steps."""
    return r * kpad_of(k) * N_TRUNK_ACTS_COLS * compute_dtype.itemsize


def fits_saved_cap(r, k, compute_dtype, cap_mb):
    """The one fit predicate of the saved stream, shared by the per-call
    gate (``KernelField``) and the per-step one (``step_save_ok``)."""
    return saved_stream_bytes(r, k, compute_dtype) <= cap_mb * 2**20


def act_stream_cols(camera):
    """bf16 columns of one row of the kernels' activation stream, from the
    library: the camera's 3072 (h0..h4, PE, h5..h7, then the heads') or the
    shadow's 2112 (h0..h4, PE, h5..h7)."""
    return int(_build.load_library().eonerf_act_stream_cols(int(camera)))


def _stream_for(camera, r, kpad, dev, stream=None):
    """The activation stream of a saved call, (R*KPAD, act_stream_cols)
    bfloat16: allocated, or ``stream`` checked."""
    shape = (r * kpad, act_stream_cols(camera))
    if stream is None:
        return torch.empty(shape, dtype=torch.bfloat16, device=dev)
    if (stream.dtype != torch.bfloat16 or tuple(stream.shape) != shape or stream.device != dev
            or not stream.is_contiguous()):
        raise ValueError(f"the activation stream must be contiguous bfloat16 {shape} on {dev}, "
                         f"got {stream.dtype} {tuple(stream.shape)} on {stream.device}")
    return stream


def _act_col(i):
    """First column of h_i in the kernels' activation stream (act_h of
    csrc/fused_render.cu): h0..h4, the PE, h5..h7."""
    return i * 256 if i < 5 else 5 * 256 + PE_PAD + (i - 5) * 256


def save_fwd_layout(camera, r, kpad):
    """Byte offsets of a save forward's workspace (the library's sv_layout;
    C entry ``eonerf_save_fwd_workspace_bytes``): the weight stream (the
    camera's STREAM_CHUNKS or the shadow's), every row's results (camera: 8
    floats, else 1), then ``total``; each part rounded up to 256 bytes."""
    up = lambda b: -(-b // 256) * 256  # noqa: E731
    res = up(STREAM_CHUNKS[camera] * STREAM_CHUNK_BYTES)
    return {"stream": 0, "res": res, "total": res + up(r * kpad * (8 if camera else 1) * 4)}


def _save_workspace(camera, r, kpad, dev):
    return torch.empty((save_fwd_layout(camera, r, kpad)["total"],), dtype=torch.uint8,
                       device=dev)


def save_fwd_plan(r, kpad, sms):
    """How the save forwards (the streamed forward's save mode) cover r rays
    of kpad samples on a card of ``sms`` SMs, as the library launches them
    (sv_grid, sv_first_ray; C entry ``eonerf_save_fwd_blocks``): every
    sample row ray * kpad + k is a row, padding and deltam = 0 included.
    ``blocks``: min(sms, STREAM_MAX_BLOCKS, r), one a block of the
    persistent grid; ``first_ray`` (blocks + 1,) int64: block b owns rays
    first_ray[b] .. first_ray[b + 1] - 1, b r // blocks (r last), so its
    rows are first_ray[b] * kpad .. first_ray[b + 1] * kpad - 1; ``rows``
    and ``tiles`` (blocks,): its rows and 128-row tiles (a ray may straddle
    two tiles; at kpad 64 two rays share one)."""
    blocks = min(sms, STREAM_MAX_BLOCKS, r)
    first = torch.arange(blocks + 1, dtype=torch.long) * r // max(blocks, 1)
    rows = (first[1:] - first[:-1]) * kpad
    return {"blocks": blocks, "first_ray": first, "rows": rows, "tiles": -(-rows // TILE_ROWS)}


def save_fwd_stores():
    """The save mode's bulk copies of a tile row into its stream row (the
    camera's and the shadow's alike), in the order a tile issues them:
    (trunk layer i, first tile column, columns, first stream column). After
    layer i's epilogue the tile's columns 0..255 hold h_i; after layer 4 the
    copy takes columns 0..319, [h4 | PE] (the PE sits in tile columns
    256..319 from before layer 0 until layer 5 reads it), so the PE is
    written once, beside h4. The camera's head columns (act_stream_cols(True)
    past 2112) are the backward's."""
    return [(i, 0, 256 + (PE_PAD if i == 4 else 0), _act_col(i)) for i in range(8)]


def save_fwd_kernel_launches():
    """Launches of the streamed forward's save mode that the library has
    made so far: {"camera", "shadow"} (C entry
    ``eonerf_save_fwd_launches``)."""
    count = (ctypes.c_longlong * 2)()
    _build.load_library().eonerf_save_fwd_launches(count)
    return {"camera": int(count[0]), "shadow": int(count[1])}


def stream_trunk_acts(stream, camera, r, k):
    """h0..h7 of a kernel's activation stream in the plain version's saved
    layout (R*K, 2048): the rows of the K real samples, layers in order."""
    rows = stream.view(r, -1, act_stream_cols(camera))[:, :k]
    return torch.cat([rows[..., _act_col(i):_act_col(i) + 256] for i in range(8)],
                     dim=-1).reshape(r * k, N_TRUNK_ACTS_COLS)


def camera_forward_save(weights: KernelWeights, rayin, z, deltam, stream=None):
    """:func:`camera_forward` that also keeps the trunk's activations for
    :func:`camera_backward_saved`: returns (acc (R, 8), acts). CPU tensors:
    the plain version, acts (R*K, 2048) = h0..h7 in the compute dtype. CUDA
    tensors: the hand-written kernel, the streamed forward's save mode over
    every sample row (:func:`save_fwd_plan`; raises if it cannot run), the
    same acc bit for bit as :func:`camera_forward`'s; acts is the activation
    stream (R*KPAD, act_stream_cols(True)) bfloat16, row ray * KPAD + k
    holding that sample's PE and h0..h7 (:func:`save_fwd_stores`; the
    backward writes the head columns). ``stream`` passes it in
    preallocated."""
    if rayin.device.type == "cpu":
        return camera_forward_reference(weights, rayin, z, deltam, save=True)
    r, kpad = _check_call(weights, rayin, z, ("deltam", deltam, z.shape))
    acc = torch.empty((r, ACC_COLS), dtype=torch.float32, device=rayin.device)
    acts = _stream_for(True, r, kpad, rayin.device, stream)
    if r == 0:
        return acc, acts
    launch("eonerf_camera_fwd_save", "camera_forward_save kernel launch", rayin.device, rayin,
           _padded(z, kpad), _padded(deltam, kpad), weights.mats, weights.biases, acc, acts, r,
           kpad, after_stream=(_save_workspace(True, r, kpad, rayin.device).data_ptr(),))
    camera_forward_save.launches += 1
    return acc, acts


camera_forward_save.launches = 0


def shadow_forward_save(weights: KernelWeights, rayin, z, deltam, mask, stream=None):
    """:func:`shadow_forward` that also keeps the trunk's activations for
    :func:`shadow_backward_saved`: (geo (R,), acts), as
    :func:`camera_forward_save` (the stream has act_stream_cols(False)
    columns)."""
    if rayin.device.type == "cpu":
        return shadow_forward_reference(weights, rayin, z, deltam, mask, save=True)
    r, kpad = _check_call(weights, rayin, z, ("deltam", deltam, z.shape), ("mask", mask, z.shape))
    geo = torch.empty((r,), dtype=torch.float32, device=rayin.device)
    acts = _stream_for(False, r, kpad, rayin.device, stream)
    if r == 0:
        return geo, acts
    launch("eonerf_shadow_fwd_save", "shadow_forward_save kernel launch", rayin.device, rayin,
           _padded(z, kpad), _padded(deltam, kpad), _padded(mask, kpad), weights.mats,
           weights.biases, geo, acts, r, kpad,
           after_stream=(_save_workspace(False, r, kpad, rayin.device).data_ptr(),))
    shadow_forward_save.launches += 1
    return geo, acts


shadow_forward_save.launches = 0


def camera_backward_saved(weights: KernelWeights, rayin, z, deltam, gacc, acts):
    """:func:`camera_backward` from the activations ``acts`` that
    :func:`camera_forward_save` kept, in place of the trunk's recompute: the
    same outputs. CPU tensors: the plain version. CUDA tensors: the
    hand-written kernels (the heads from the stream, then dgrad, wgrad and
    the reduction; raises if they cannot run)."""
    if rayin.device.type == "cpu":
        return camera_backward_reference(weights, rayin, z, deltam, gacc, acts=acts)
    r, kpad = _check_call(weights, rayin, z, ("deltam", deltam, z.shape),
                          ("gacc", gacc, (z.shape[0], ACC_COLS)))
    dev = rayin.device
    _stream_for(True, r, kpad, dev, acts)
    grads = _zero_grads(r, dev)
    if r == 0:
        return grads
    launch("eonerf_camera_bwd_saved", "camera_backward_saved kernel launch", dev, rayin,
           _padded(z, kpad), _padded(deltam, kpad), gacc, weights.mats, weights.biases, acts,
           _workspace(True, r, kpad, dev, saved=True), *grads, r, kpad)
    camera_backward_saved.launches += 1
    return grads


camera_backward_saved.launches = 0


def shadow_backward_saved(weights: KernelWeights, rayin, z, deltam, mask, ggeo, acts):
    """:func:`shadow_backward` from the activations ``acts`` that
    :func:`shadow_forward_save` kept, as :func:`camera_backward_saved`."""
    if rayin.device.type == "cpu":
        return shadow_backward_reference(weights, rayin, z, deltam, mask, ggeo, acts=acts)
    r, kpad = _check_call(weights, rayin, z, ("deltam", deltam, z.shape), ("mask", mask, z.shape),
                          ("ggeo", ggeo, (z.shape[0],)))
    dev = rayin.device
    _stream_for(False, r, kpad, dev, acts)
    grads = _zero_grads(r, dev)
    if r == 0:
        return grads
    launch("eonerf_shadow_bwd_saved", "shadow_backward_saved kernel launch", dev, rayin,
           _padded(z, kpad), _padded(deltam, kpad), _padded(mask, kpad), ggeo, weights.mats,
           weights.biases, acts, _workspace(False, r, kpad, dev, saved=True), *grads, r, kpad)
    shadow_backward_saved.launches += 1
    return grads


shadow_backward_saved.launches = 0


# ---------------------------------------------------------------------------
# the int8 tier's wrappers
# ---------------------------------------------------------------------------

_MODES = {"camera": 0, "shadow": 1, "coarse": 2}


def check_q8(q8: Q8Weights, device):
    for name, t, dtype, n in (("w8", q8.w8, torch.int8, TRUNK_MAT_ELEMENTS),
                              ("w8t", q8.w8t, torch.int8, TRUNK_MAT_ELEMENTS),
                              ("scales", q8.scales, torch.float32, 8 * 256)):
        if t.device != device or t.dtype != dtype or tuple(t.shape) != (n,):
            raise ValueError(f"q8.{name} must be {dtype} ({n},) on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"q8.{name} must be contiguous and 16-byte aligned")


def _q8_call(weights, q8, rayin, per_sample, target, per_ray=()):
    """Checks, then the call padded to whole scale groups: (padded rayin,
    per-ray and per-sample tensors, KPAD, rays per group, padded rays)."""
    r, k = per_sample[0].shape
    dev = rayin.device
    check_f32("rayin", rayin, (r, RAYIN_COLS), dev)
    for i, x in enumerate(per_sample):
        check_f32(f"per-sample input {i}", x, (r, k), dev)
    check_weights(weights, dev)
    check_q8(q8, dev)
    kpad, rt, rp = q8_plan(r, k, target)
    if kpad > MAX_KPAD:
        raise ValueError(f"{k} samples per ray exceed the kernel's {MAX_KPAD}")
    (rayin, *per_ray), per_sample = _pad_call(rp, kpad, [rayin, *per_ray], list(per_sample))
    return ([x.contiguous() for x in (rayin, *per_ray)], [x.contiguous() for x in per_sample],
            kpad, rt, rp)


def _path_arg(path):
    """The C library's path argument: -1 (the shape's), or a forced one of
    :data:`Q8_TRUNK_PATHS` (tests and measurements)."""
    return -1 if path is None else Q8_TRUNK_PATHS.index(path)


def _q8_forward(mode, weights, q8, rayin, z, deltam, mask, target, stats, path=None):
    r, k = z.shape
    per_sample = (z, deltam) if mask is None else (z, deltam, mask)
    (rayin_p,), ps, kpad, rt, rp = _q8_call(weights, q8, rayin, per_sample, target)
    dev = rayin.device
    lib = _build.load_library()
    ws = torch.empty((lib.eonerf_q8_fwd_workspace_bytes(_MODES[mode], rp, kpad, rt * kpad,
                                                        _path_arg(path)),),
                     dtype=torch.uint8, device=dev)
    amax = torch.zeros((rp // rt, Q8_POINTS), dtype=torch.float32, device=dev)
    shape = {"camera": (rp, ACC_COLS), "shadow": (rp,), "coarse": (rp, kpad)}[mode]
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    launch("eonerf_q8_fwd", f"{mode} int8 forward kernel launch", dev, _MODES[mode], rayin_p,
           ps[0], ps[1], ps[2] if mask is not None else None, weights.mats, weights.biases, q8.w8,
           q8.scales, ws, amax, out, rp, kpad, rt * kpad, after_stream=(_path_arg(path),))
    cols = act_stream_cols(mode == "camera")
    _keep(stats, amax=amax, acts=ws[:rp * kpad * cols * 2].view(torch.bfloat16).view(-1, cols))
    return out[:r, :k] if mode == "coarse" else out[:r]


def camera_forward_q8(weights: KernelWeights, q8: Q8Weights, rayin, z, deltam, tile_target=2048,
                      stats=None):
    """:func:`camera_forward` with the trunk in int8, scale groups of about
    ``tile_target`` rows. CPU tensors: the plain version. CUDA tensors: the
    int8 trunk kernels, then the heads and compositing from the activation
    stream (raises if they cannot run). ``stats`` receives the group amax
    and, from the kernels, the activation stream they wrote (``acts``, rows
    of 3072 (camera) or 2112 bf16: the PE and h7 hold data, see
    :func:`q8_trunk`)."""
    if rayin.device.type == "cpu":
        return camera_forward_reference(weights, rayin, z, deltam, q8, tile_target, stats)
    out = _q8_forward("camera", weights, q8, rayin, z, deltam, None, tile_target, stats)
    camera_forward_q8.launches += 1
    return out


camera_forward_q8.launches = 0


def shadow_forward_q8(weights: KernelWeights, q8: Q8Weights, rayin, z, deltam, mask,
                      tile_target=2048, stats=None):
    """:func:`shadow_forward` with the trunk in int8, as
    :func:`camera_forward_q8`."""
    if rayin.device.type == "cpu":
        return shadow_forward_reference(weights, rayin, z, deltam, mask, q8, tile_target, stats)
    out = _q8_forward("shadow", weights, q8, rayin, z, deltam, mask, tile_target, stats)
    shadow_forward_q8.launches += 1
    return out


shadow_forward_q8.launches = 0


def coarse_forward_q8(weights: KernelWeights, q8: Q8Weights, rayin, z, deltam, tile_target=2048,
                      stats=None):
    """:func:`coarse_forward` with the trunk in int8, as
    :func:`camera_forward_q8`."""
    if rayin.device.type == "cpu":
        return coarse_forward_reference(weights, rayin, z, deltam, q8, tile_target, stats)
    out = _q8_forward("coarse", weights, q8, rayin, z, deltam, None, tile_target, stats)
    coarse_forward_q8.launches += 1
    return out


coarse_forward_q8.launches = 0


def q8_stream_cols(write_all):
    """Column ranges of the activation stream that the int8 trunk writes:
    the PE, and h7 (the forwards) or h0..h7 (``write_all``: the backwards'
    recompute)."""
    return [(5 * 256, 5 * 256 + PE_PAD)] + [(_act_col(i), _act_col(i) + 256)
                                             for i in (range(8) if write_all else (7,))]


def q8_stream_written(stream, write_all):
    """The columns of an int8 activation stream that hold data, side by
    side (PE first)."""
    return torch.cat([stream[:, a:b] for a, b in q8_stream_cols(write_all)], dim=1)


def q8_trunk(weights: KernelWeights, q8: Q8Weights, rayin, z, tile_target=2048, camera=True,
             write_all=False, path=None):
    """The int8 trunk alone, as the int8 forwards (``write_all`` False) and
    backwards (True: the recompute) run it, in scale groups of about
    ``tile_target`` rows, the call padded to whole groups: returns (the
    activation stream (rows, act_stream_cols(camera)), the group amax (G,
    8)); the columns :func:`q8_stream_cols` names hold data. For tests and
    measurements. CPU tensors: the plain version (``trunk_q8`` in the
    weights' dtype, the stream zero elsewhere). CUDA tensors: the kernels
    on ``path`` (None: the one :func:`q8_trunk_plan` names; "cluster" or
    "layer_major" forces one, and a launch the card refuses raises)."""
    if rayin.device.type == "cpu":
        rayin_p, _, (z_p,), gr = _inputs(rayin, (z,), q8, tile_target)
        dtype = weights.dtype
        pe = _pe(rayin_p, z_p, dtype).reshape(-1, PE_PAD)
        acts, _, amax = _trunk_of(pe, kernel_views(weights), dtype, q8, gr)
        stream = torch.zeros((pe.shape[0], PLAIN_STREAM_COLS[bool(camera)]), dtype=dtype)
        for (a, b), x in zip(q8_stream_cols(write_all), [pe] + (acts if write_all else acts[-1:])):
            stream[:, a:b] = x
        return stream, amax
    (rayin_p,), (z_p,), kpad, rt, rp = _q8_call(weights, q8, rayin, (z,), tile_target)
    dev = rayin.device
    lib = _build.load_library()
    cols = act_stream_cols(camera)
    stream = torch.empty((rp * kpad, cols), dtype=torch.bfloat16, device=dev)
    amax = torch.zeros((rp // rt, Q8_POINTS), dtype=torch.float32, device=dev)
    ws = torch.empty((lib.eonerf_q8_trunk_workspace_bytes(rp, kpad, rt * kpad, _path_arg(path)),),
                     dtype=torch.uint8, device=dev)
    launch("eonerf_q8_trunk", "int8 trunk kernel launch", dev, _path_arg(path), rayin_p, z_p,
           stream, cols, int(write_all), q8.w8, q8.scales, weights.biases, ws, amax, rp, kpad,
           rt * kpad)
    q8_trunk.launches += 1
    return stream, amax


q8_trunk.launches = 0

# the int8 trunk's CUDA kernels, in the order the library counts them
Q8_TRUNK_KERNELS = ("q8_trunk_cluster_kernel", "q8_pe_kernel", "q8_layer_kernel")


def q8_trunk_kernel_launches():
    """Launches of the int8 trunk's CUDA kernels that the library has made
    so far, by kernel name: counted in csrc/fused_render.cu's ``q8_trunk``
    where it launches each, whichever wrapper called it."""
    counts = (ctypes.c_longlong * len(Q8_TRUNK_KERNELS))()
    _build.load_library().eonerf_q8_trunk_launches(counts)
    return dict(zip(Q8_TRUNK_KERNELS, counts))


# ---- int8_full's trunk backward: the cotangent chain and the weight gradient ----

Q8_WGRAD_TILE = 64   # q8_wgrad_kernel's tiles: 64 input x 64 output features
_TRUNK_IN = (64, 256, 256, 256, 256, 320, 256, 256)   # the trunk's padded input widths
# the C library's int8_full trunk-backward kernels, in the order it counts them
Q8_BWD_KERNELS = ("q8_chain_cluster_kernel", "q8_wgrad_kernel", "q8_gamax_kernel",
                  "q8_dgrad_kernel", "q8_reduce_kernel")
# q8_chain_cluster_kernel's shared memory (csrc/fused_render.cu: QC_STAGES
# chunks of 320 x 64 bytes, the int8 tile MT x LDH, the staged activations
# MT x LDM, the int8 tile transposed W x LDT, 16 warps' column sums of 128
# f32, the layer's s_w, 8 x 16 + 16 maxima)
Q8_CHAIN_CARVE = {"ring": 4 * 320 * 64, "g8_tile": 128 * (256 + 16),
                  "mask_tile": 128 * (512 + 16), "g8_transposed": 256 * (128 + 16),
                  "column_sums": 16 * 128 * 4, "s_w": 256 * 4, "maxima": (8 * 16 + 16) * 4}
# q8_wgrad_kernel's: 4 stages of (256 rows x 64 bf16 inputs, 64 g8 features
# x 256 rows), then two quantized chunks
Q8_WGRAD_CARVE = {"ring": 4 * (256 * 64 * 2 + 64 * 256), "a8_tiles": 2 * 64 * 256}
SMEM_LIMIT = 232448   # an H100 block's shared memory


def q8_g8_rows(group_rows):
    """The int8 cotangent stream's run of rows a group: its rows rounded up
    to the weight gradient's 256-row chunks (csrc/fused_render.cu's
    ``q8_g8_rows``)."""
    return -(-group_rows // 256) * 256


def q8_wgrad_tiles():
    """q8_wgrad_kernel's tiles in block order: (layer, first input feature,
    first output feature), 64 x 64 each; every trunk weight in exactly one."""
    return [(layer, m0, n0) for layer, n_in in enumerate(_TRUNK_IN)
            for m0 in range(0, n_in, Q8_WGRAD_TILE) for n0 in range(0, 256, Q8_WGRAD_TILE)]


def q8_bwd_plan(kpad, group_rows):
    """How the kernels run int8_full's trunk backward for groups of
    ``group_rows`` rows of ``kpad`` samples, mirroring csrc/fused_render.cu
    (``eonerf_q8_bwd_plan``): the chain's path, which is the trunk's
    (:func:`q8_trunk_plan`: "cluster", q8_chain_cluster_kernel, a cluster a
    group; "layer_major", q8_gamax_kernel + q8_dgrad_kernel a layer), its
    CTAs a group and a group's last CTA's rows, the cluster kernel's shared
    memory carve, q8_wgrad_kernel's tiles and carve, and the int8 stream's
    run of rows a group."""
    path, ctas, last = q8_trunk_plan(kpad, group_rows)
    return {"path": path, "ctas": ctas, "last_cta_rows": last,
            "chain_smem": dict(Q8_CHAIN_CARVE, total=sum(Q8_CHAIN_CARVE.values())),
            "wgrad_tiles": q8_wgrad_tiles(),
            "wgrad_smem": dict(Q8_WGRAD_CARVE, total=sum(Q8_WGRAD_CARVE.values())),
            "g8_rows": q8_g8_rows(group_rows)}


def q8_g8_stream(g8s, group_rows):
    """The kernels' int8 cotangent stream from the plain version's 8 layers'
    g8 (rows x 256 each, integer values): (groups * 8 * 256 * run,) int8,
    K-major for the weight gradient, whose contraction runs over rows: byte
    ((group * 8 + layer) * 256 + feature) * run + row in group, run =
    :func:`q8_g8_rows`; the bytes past a group's rows zero (the kernels
    leave them unwritten)."""
    rows = g8s[0].shape[0]
    n_g, run = rows // group_rows, q8_g8_rows(group_rows)
    out = torch.zeros((n_g, 8, 256, run), dtype=torch.int8, device=g8s[0].device)
    for layer, x in enumerate(g8s):
        out[:, layer, :, :group_rows] = x.to(torch.int8).view(n_g, group_rows, 256).transpose(1, 2)
    return out.reshape(-1)


def q8_g8_layers(stream, rows, group_rows):
    """The inverse of :func:`q8_g8_stream`: the 8 layers' g8 (rows x 256,
    int8) of a stream."""
    n_g, run = rows // group_rows, q8_g8_rows(group_rows)
    s = stream[:n_g * 8 * 256 * run].view(n_g, 8, 256, run)[..., :group_rows]
    return [s[:, layer].transpose(1, 2).reshape(rows, 256) for layer in range(8)]


def q8_bwd_kernel_launches():
    """Launches of int8_full's trunk-backward CUDA kernels that the library
    has made so far, by kernel name: counted in csrc/fused_render.cu where
    it launches each, whichever wrapper called it."""
    counts = (ctypes.c_longlong * len(Q8_BWD_KERNELS))()
    _build.load_library().eonerf_q8_bwd_launches(counts)
    return dict(zip(Q8_BWD_KERNELS, counts))


def _q8_workspace(camera, full, rp, kpad, group_rows, dev, path=-1):
    """The int8 backward kernels' scratch (it starts with the bf16
    backward's), sized by the library for the trunk's path (the C
    library's number, -1 the shape's)."""
    nbytes = _build.load_library().eonerf_q8_bwd_workspace_bytes(int(camera), int(full), rp, kpad,
                                                                 group_rows, path)
    return torch.empty((nbytes,), dtype=torch.uint8, device=dev)


class Q8BackwardCall:
    """One int8 backward call's checked, padded arguments and buffers (the
    workspace, the group amax, the gradients): ``run()`` launches the whole
    backward, ``run(pass_)`` one pass of an int8_full one alone (the C
    library's ``eonerf_q8_bwd_pass``: 0 the recompute and the heads, 1 the
    cotangent chain, 2 the weight gradient, 3 the bias reduction, 4 the
    per-ray gradients) on the buffers the passes before it filled. For the
    wrappers, tests and measurements."""

    def __init__(self, camera, full, weights, q8, rayin, z, deltam, mask, gin, target, path=None):
        r, k = z.shape
        dev = rayin.device
        if camera:
            check_f32("gacc", gin, (r, ACC_COLS), dev)
            per_sample = (z, deltam)
        else:
            check_f32("ggeo", gin, (r,), dev)
            per_sample, gin = (z, deltam, mask), gin.reshape(-1, 1)
        (rayin_p, gin_p), ps, kpad, rt, rp = _q8_call(weights, q8, rayin, per_sample, target,
                                                      (gin,))
        self.camera, self.full, self.r, self.rp, self.kpad = camera, full, r, rp, kpad
        self.group_rows, self.path = rt * kpad, _path_arg(path)
        self.ws = _q8_workspace(camera, full, rp, kpad, rt * kpad, dev, self.path)
        self.amax = torch.zeros((rp // rt, Q8_POINTS), dtype=torch.float32, device=dev)
        self.gamax = torch.zeros_like(self.amax)
        self.grads = _zero_grads(rp, dev)
        self._inputs = (rayin_p, ps[0], ps[1], None if camera else ps[2], gin_p, weights.mats,
                        weights.biases, q8.w8, q8.w8t, q8.scales, self.ws, self.amax, self.gamax,
                        *self.grads)

    def run(self, pass_=-1):
        dev = self.ws.device
        what = f"{'camera' if self.camera else 'shadow'} int8 backward kernel launch"
        if pass_ < 0:
            launch("eonerf_q8_bwd", what, dev, int(self.camera), int(self.full), *self._inputs,
                   self.rp, self.kpad, self.group_rows, after_stream=(self.path,))
            return
        launch("eonerf_q8_bwd_pass", f"{what} (pass {pass_})", dev, int(self.camera), pass_,
               *self._inputs, self.rp, self.kpad, self.group_rows, after_stream=(self.path,))

    def layout(self):
        """The C library's eonerf_q8_bwd_layout: {"gh", "gpe", "g8",
        "qbpart" (byte offsets), "bias_rows", "g8_rows", "total"}."""
        out = (ctypes.c_longlong * 7)()
        _build.load_library().eonerf_q8_bwd_layout(int(self.camera), self.rp, self.kpad,
                                                   self.group_rows, self.path, out)
        return dict(zip(("gh", "gpe", "g8", "qbpart", "bias_rows", "g8_rows", "total"), out))

    def g8_stream(self):
        """The int8 cotangent stream the chain wrote (a view of the
        workspace), in :func:`q8_g8_stream`'s layout."""
        lay = self.layout()
        n = self.rp * self.kpad // self.group_rows * 8 * 256 * lay["g8_rows"]
        return self.ws[lay["g8"]:lay["g8"] + n].view(torch.int8)

    def act_stream(self):
        """The recompute's activation stream (a view of the workspace)."""
        cols = act_stream_cols(self.camera)
        return self.ws[:self.rp * self.kpad * cols * 2].view(torch.bfloat16).view(-1, cols)


def _q8_backward(camera, full, weights, q8, rayin, z, deltam, mask, gin, target, stats,
                 path=None):
    call = Q8BackwardCall(camera, full, weights, q8, rayin, z, deltam, mask, gin, target, path)
    call.run()
    _keep(stats, amax=call.amax, **({"gamax": call.gamax} if full else {}))
    d_mats, d_biases, d_rayin = call.grads
    return d_mats, d_biases, d_rayin[:call.r]


def camera_backward_q8(weights: KernelWeights, q8: Q8Weights, rayin, z, deltam, gacc,
                       tile_target=1024, stats=None):
    """:func:`camera_backward` of the ``int8`` tier: the int8 recompute in
    scale groups of about ``tile_target`` rows, then the bf16 dgrad and wgrad
    against the unquantized weights (straight-through). CPU tensors: the
    plain version. CUDA tensors: the kernels (raises if they cannot run)."""
    if rayin.device.type == "cpu":
        return camera_backward_reference(weights, rayin, z, deltam, gacc, q8, False, tile_target,
                                         stats)
    out = _q8_backward(True, False, weights, q8, rayin, z, deltam, None, gacc, tile_target, stats)
    camera_backward_q8.launches += 1
    return out


camera_backward_q8.launches = 0


def camera_backward_q8_full(weights: KernelWeights, q8: Q8Weights, rayin, z, deltam, gacc,
                            tile_target=1024, stats=None):
    """:func:`camera_backward` of the ``int8_full`` tier: the int8 recompute,
    then the trunk's dgrad and wgrad in int8 layer by layer (the heads' in
    bf16). CPU tensors: the plain version. CUDA tensors: the kernels."""
    if rayin.device.type == "cpu":
        return camera_backward_reference(weights, rayin, z, deltam, gacc, q8, True, tile_target,
                                         stats)
    out = _q8_backward(True, True, weights, q8, rayin, z, deltam, None, gacc, tile_target, stats)
    camera_backward_q8_full.launches += 1
    return out


camera_backward_q8_full.launches = 0


def shadow_backward_q8(weights: KernelWeights, q8: Q8Weights, rayin, z, deltam, mask, ggeo,
                       tile_target=1024, stats=None):
    """:func:`shadow_backward` of the ``int8`` tier, as
    :func:`camera_backward_q8`."""
    if rayin.device.type == "cpu":
        return shadow_backward_reference(weights, rayin, z, deltam, mask, ggeo, q8, False,
                                         tile_target, stats)
    out = _q8_backward(False, False, weights, q8, rayin, z, deltam, mask, ggeo, tile_target,
                       stats)
    shadow_backward_q8.launches += 1
    return out


shadow_backward_q8.launches = 0


def shadow_backward_q8_full(weights: KernelWeights, q8: Q8Weights, rayin, z, deltam, mask, ggeo,
                            tile_target=1024, stats=None):
    """:func:`shadow_backward` of the ``int8_full`` tier, as
    :func:`camera_backward_q8_full`."""
    if rayin.device.type == "cpu":
        return shadow_backward_reference(weights, rayin, z, deltam, mask, ggeo, q8, True,
                                         tile_target, stats)
    out = _q8_backward(False, True, weights, q8, rayin, z, deltam, mask, ggeo, tile_target,
                       stats)
    shadow_backward_q8_full.launches += 1
    return out


shadow_backward_q8_full.launches = 0


# ---------------------------------------------------------------------------
# differentiable ops (the JAX package's custom_vjp pairs)
# ---------------------------------------------------------------------------

def _quantized(mats, dtype, trunk_quant):
    """The compute-dtype weights' matrices and, for an int8 tier, the int8
    trunk quantized from the float32 ones (None otherwise)."""
    return mats.to(dtype), (quantize_kernel_trunk(mats) if trunk_quant else None)


def _check_save(save, trunk_quant):
    if save and trunk_quant:
        raise ValueError("the saved activations are never combined with the int8 trunk "
                         "(the JAX package refuses the pair too)")


class _Camera(torch.autograd.Function):
    """``save``: the forward keeps the trunk's activations (when some input
    needs a gradient) and the backward reads them; else the forward saves
    only its inputs (and the int8 trunk) and the backward recomputes.
    ``trunk_quant``: False, True (int8) or "full" (int8_full); ``tiles``: the
    forward's and the backward's scale-group targets."""

    @staticmethod
    def forward(ctx, mats, biases, rayin, z, deltam, dtype, trunk_quant, tiles, save):
        mats_cd, q8 = _quantized(mats, dtype, trunk_quant)
        ctx.quant, ctx.bwd_tile = trunk_quant, tiles[1]
        ctx.saved = save and any(ctx.needs_input_grad[:3])
        weights = KernelWeights(mats_cd, biases)
        if ctx.saved:
            acc, acts = camera_forward_save(weights, rayin, z, deltam)
            ctx.save_for_backward(mats_cd, biases, rayin, z, deltam, acts)
            return acc
        ctx.save_for_backward(mats_cd, biases, rayin, z, deltam, *(q8 or ()))
        return camera_forward(weights, rayin, z, deltam, q8, tiles[0])

    @staticmethod
    def backward(ctx, gacc):
        mats, biases, rayin, z, deltam, *extra = ctx.saved_tensors
        weights = KernelWeights(mats, biases)
        if ctx.saved:
            grads = camera_backward_saved(weights, rayin, z, deltam, gacc.contiguous(), extra[0])
        else:
            grads = camera_backward(weights, rayin, z, deltam, gacc.contiguous(),
                                    Q8Weights(*extra) if extra else None, ctx.quant == "full",
                                    ctx.bwd_tile)
        return (*grads, None, None, None, None, None, None)


class _Shadow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mats, biases, rayin, z, deltam, mask, dtype, trunk_quant, tiles, save):
        mats_cd, q8 = _quantized(mats, dtype, trunk_quant)
        ctx.quant, ctx.bwd_tile = trunk_quant, tiles[1]
        ctx.saved = save and any(ctx.needs_input_grad[:3])
        weights = KernelWeights(mats_cd, biases)
        if ctx.saved:
            geo, acts = shadow_forward_save(weights, rayin, z, deltam, mask)
            ctx.save_for_backward(mats_cd, biases, rayin, z, deltam, mask, acts)
            return geo
        ctx.save_for_backward(mats_cd, biases, rayin, z, deltam, mask, *(q8 or ()))
        return shadow_forward(weights, rayin, z, deltam, mask, q8, tiles[0])

    @staticmethod
    def backward(ctx, ggeo):
        mats, biases, rayin, z, deltam, mask, *extra = ctx.saved_tensors
        weights = KernelWeights(mats, biases)
        if ctx.saved:
            grads = shadow_backward_saved(weights, rayin, z, deltam, mask, ggeo.contiguous(),
                                          extra[0])
        else:
            grads = shadow_backward(weights, rayin, z, deltam, mask, ggeo.contiguous(),
                                    Q8Weights(*extra) if extra else None, ctx.quant == "full",
                                    ctx.bwd_tile)
        return (*grads, None, None, None, None, None, None, None)


def fused_camera(weights: KernelWeights, rayin, z, deltam, compute_dtype, trunk_quant=False,
                 tile=2048, bwd_tile=1024, save=False):
    """Differentiable camera op. ``weights`` holds the float32 packed
    matrices (cast to ``compute_dtype`` inside, so their gradients arrive in
    float32, as the parameters' own dtype); gradients flow to the weights
    and to ``rayin``, none to z or deltam. ``trunk_quant`` True runs the
    trunk in int8 (forward and the backward's recompute; straight-through
    gradients), "full" also the trunk's dgrad and wgrad; ``tile`` and
    ``bwd_tile`` are the forward's and the backward's scale-group targets
    in rows (the JAX package's ``PallasField`` tile sizes). ``save`` keeps
    the trunk's activations from the forward for the backward (never with
    ``trunk_quant``); a call under ``torch.no_grad()``, or with no input
    that needs a gradient, saves nothing, as the JAX package's
    undifferentiated primal."""
    _check_save(save, trunk_quant)
    return _Camera.apply(weights.mats, weights.biases, rayin, z, deltam, compute_dtype,
                         trunk_quant, (tile, bwd_tile), save and torch.is_grad_enabled())


def fused_shadow(weights: KernelWeights, rayin, z, deltam, mask, compute_dtype, trunk_quant=False,
                 tile=2048, bwd_tile=1024, save=False):
    """Differentiable shadow op, as :func:`fused_camera`."""
    _check_save(save, trunk_quant)
    return _Shadow.apply(weights.mats, weights.biases, rayin, z, deltam, mask, compute_dtype,
                         trunk_quant, (tile, bwd_tile), save and torch.is_grad_enabled())


def fused_coarse(weights: KernelWeights, rayin, z, deltam, compute_dtype, trunk_quant=False,
                 tile=2048):
    """The coarse op, forward only: inputs and result cut from autograd (the
    JAX package's ``stop_gradient`` around ``make_fused_coarse``), since the
    hierarchical sampler draws its fine samples under a stop-gradient.
    ``weights`` holds the float32 packed matrices, cast here; with
    ``trunk_quant`` the trunk runs in int8 (scale groups of about ``tile``
    rows)."""
    with torch.no_grad():
        mats_cd, q8 = _quantized(weights.mats.detach(), compute_dtype, trunk_quant)
        return coarse_forward(KernelWeights(mats_cd, weights.biases.detach()), rayin.detach(),
                              z.detach(), deltam.detach(), q8, tile)
