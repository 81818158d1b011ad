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

import torch
import torch.nn.functional as F

from eonerf_code_tpu_torch.ops import _build
from eonerf_code_tpu_torch.ops.fused_field import (
    BIAS_ELEMENTS,
    MAT_ELEMENTS,
    PE_PAD,
    KernelWeights,
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
    sigma_backward,
    softplus,
    trunk,
    trunk_backward,
)
from eonerf_code_tpu_torch.ops.volrend import exclusive_cumsum

RAYIN_COLS = 16   # [o(3), d(3), emb(4), pad(6)]
ACC_COLS = 8      # [depth, albedo r g b, t_s, t_beta, opacity, pad]
MAX_KPAD = 1024   # the kernels keep every sample of a ray's results in shared memory


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


def camera_forward_reference(weights: KernelWeights, rayin, z, deltam):
    """Plain PyTorch version of :func:`camera_forward` (any K, no padding
    needed: padded samples add nothing)."""
    dtype = weights.dtype
    w = kernel_views(weights)
    r, k = z.shape
    z = z.float()
    pe = _pe(rayin.float(), z, dtype)
    sigma, albedo, ts, tb, _ = heads(trunk(pe, w, dtype)[0][-1], _emb64(rayin, r, k), w,
                                     dtype)
    sdelta = sigma.view(r, k) * deltam.float()
    weights_rk = torch.exp(-exclusive_cumsum(sdelta)) * (1.0 - torch.exp(-sdelta))
    values = torch.cat([z[..., None], albedo.view(r, k, 3), ts.view(r, k, 1),
                        tb.view(r, k, 1), torch.ones_like(z)[..., None],
                        torch.zeros_like(z)[..., None]], dim=-1)
    return (weights_rk[..., None] * values).sum(dim=1)


def shadow_forward_reference(weights: KernelWeights, rayin, z, deltam, mask):
    """Plain PyTorch version of :func:`shadow_forward`."""
    dtype = weights.dtype
    w = kernel_views(weights)
    r, k = z.shape
    pe = _pe(rayin.float(), z.float(), dtype)
    sigma = softplus(mm(trunk(pe, w, dtype)[0][-1], w.sigma_w, w.sigma_b)).view(r, k)
    sdelta = sigma * deltam.float()
    return torch.exp(-(sdelta * _before_last(mask)).sum(dim=-1))


def coarse_forward_reference(weights: KernelWeights, rayin, z, deltam):
    """Plain PyTorch version of :func:`coarse_forward`: the density trunk and
    the per-sample weights T_i (1 - e^(-sigma_i deltam_i)) with the
    EXCLUSIVE transmittance T_i, as ``render_weights``."""
    dtype = weights.dtype
    w = kernel_views(weights)
    r, k = z.shape
    pe = _pe(rayin.float(), z.float(), dtype)
    sigma = softplus(mm(trunk(pe, w, dtype)[0][-1], w.sigma_w, w.sigma_b)).view(r, k)
    sdelta = sigma * deltam.float()
    return torch.exp(-exclusive_cumsum(sdelta)) * (1.0 - torch.exp(-sdelta))


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


def camera_backward_reference(weights: KernelWeights, rayin, z, deltam, gacc):
    """Plain PyTorch version of :func:`camera_backward`: the VJP of the
    camera op for the per-ray cotangent ``gacc`` (R, 8), recomputing the
    forward. Mirrors the JAX package's ``_camera_bwd_kernel`` step by step
    at its rounding points. Returns (d_mats, d_biases) in the packed
    layout, float32, and d_rayin (R, 16) = [d_o, d_d, d_emb, 0]."""
    dtype = weights.dtype
    w = kernel_views(weights)
    r, k = z.shape
    z, deltam, gacc = z.float(), deltam.float(), gacc.float()
    xb = _pe_args(rayin.float(), z)
    pe = pe_from_args(xb, dtype)
    acts, masks = trunk(pe, w, dtype)
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
    g_pe = trunk_backward(pe, acts, masks, g_h, w, dtype, g)
    d_o, d_d = _ray_grads(xb, z, g_pe, dtype, r, k)
    d_emb = g_emb.view(r, k, 4).sum(dim=1)
    d_rayin = torch.cat([d_o, d_d, d_emb, torch.zeros((r, RAYIN_COLS - 10), device=z.device)],
                        dim=1)
    return (*pack_grads(g), d_rayin)


def shadow_backward_reference(weights: KernelWeights, rayin, z, deltam, mask, ggeo):
    """Plain PyTorch version of :func:`shadow_backward`: the VJP of the
    shadow op for the per-ray cotangent ``ggeo`` (R,), mirroring the JAX
    package's ``_shadow_bwd_kernel``. Returns (d_mats, d_biases) in the
    packed layout, float32, zero past the density prefix (the heads get
    exact zeros), and d_rayin (R, 16) = [d_o, d_d, 0]."""
    dtype = weights.dtype
    w = kernel_views(weights)
    r, k = z.shape
    z, deltam = z.float(), deltam.float()
    xb = _pe_args(rayin.float(), z)
    pe = pe_from_args(xb, dtype)
    acts, masks = trunk(pe, w, dtype)
    sig_pre = mm(acts[-1], w.sigma_w, w.sigma_b)
    before_last = _before_last(mask)
    geo = torch.exp(-(softplus(sig_pre).view(r, k) * deltam * before_last).sum(dim=-1))
    d_ev = -geo * ggeo.float().reshape(-1)
    d_sigma = (d_ev[:, None] * before_last * deltam).reshape(-1, 1)
    g, g_pe = sigma_backward(pe, acts, masks, sig_pre, d_sigma, w, dtype)
    d_o, d_d = _ray_grads(xb, z, g_pe, dtype, r, k)
    d_rayin = torch.cat([d_o, d_d, torch.zeros((r, RAYIN_COLS - 6), device=z.device)], dim=1)
    return (*pack_grads(g), d_rayin)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def kpad_of(k):
    """Samples padded to a multiple of 8 (the kernels' tile rows)."""
    return ((max(k, 1) + 7) // 8) * 8


def _padded(x, kpad):
    return F.pad(x, (0, kpad - x.shape[1])).contiguous()


def camera_forward(weights: KernelWeights, rayin, z, deltam):
    """Per-ray camera accumulators (R, 8) for rays (R, 16), z and deltam
    (R, K). CPU tensors: the plain version. CUDA tensors: the hand-written
    bf16 kernel (raises if it cannot be built or launched)."""
    if rayin.device.type == "cpu":
        return camera_forward_reference(weights, rayin, z, deltam)
    r, k = z.shape
    kpad = kpad_of(k)
    dev = rayin.device
    check_f32("rayin", rayin, (r, RAYIN_COLS), dev)
    check_f32("z", z, (r, k), dev)
    check_f32("deltam", deltam, (r, k), dev)
    check_weights(weights, dev)
    if kpad > MAX_KPAD:
        raise ValueError(f"{k} samples per ray exceed the kernel's {MAX_KPAD}")
    acc = torch.empty((r, ACC_COLS), dtype=torch.float32, device=dev)
    if r == 0:
        return acc
    zp, dp = _padded(z, kpad), _padded(deltam, kpad)
    launch("eonerf_camera_fwd", "camera_forward kernel launch", dev, rayin, zp, dp, weights.mats,
           weights.biases, acc, r, kpad)
    camera_forward.launches += 1
    return acc


camera_forward.launches = 0


def shadow_forward(weights: KernelWeights, rayin, z, deltam, mask):
    """Per-ray sun visibility (R,) for shadow rays (R, 16), z, deltam and
    the float 0/1 validity mask (R, K). CPU tensors: the plain version. CUDA
    tensors: the hand-written bf16 kernel (raises if it cannot run)."""
    if rayin.device.type == "cpu":
        return shadow_forward_reference(weights, rayin, z, deltam, mask)
    r, k = z.shape
    kpad = kpad_of(k)
    dev = rayin.device
    check_f32("rayin", rayin, (r, RAYIN_COLS), dev)
    check_f32("z", z, (r, k), dev)
    check_f32("deltam", deltam, (r, k), dev)
    check_f32("mask", mask, (r, k), dev)
    check_weights(weights, dev)
    if kpad > MAX_KPAD:
        raise ValueError(f"{k} samples per ray exceed the kernel's {MAX_KPAD}")
    geo = torch.empty((r,), dtype=torch.float32, device=dev)
    if r == 0:
        return geo
    zp, dp, mp = _padded(z, kpad), _padded(deltam, kpad), _padded(mask, kpad)
    launch("eonerf_shadow_fwd", "shadow_forward kernel launch", dev, rayin, zp, dp, mp,
           weights.mats, weights.biases, geo, r, kpad)
    shadow_forward.launches += 1
    return geo


shadow_forward.launches = 0


def coarse_forward(weights: KernelWeights, rayin, z, deltam):
    """Per-sample compositing weights (R, K) of the density field for rays
    (R, 16), z and deltam (R, K). CPU tensors: the plain version. CUDA
    tensors: the hand-written bf16 kernel (raises if it cannot run)."""
    if rayin.device.type == "cpu":
        return coarse_forward_reference(weights, rayin, z, deltam)
    r, k = z.shape
    kpad = kpad_of(k)
    dev = rayin.device
    check_f32("rayin", rayin, (r, RAYIN_COLS), dev)
    check_f32("z", z, (r, k), dev)
    check_f32("deltam", deltam, (r, k), dev)
    check_weights(weights, dev)
    if kpad > MAX_KPAD:
        raise ValueError(f"{k} samples per ray exceed the kernel's {MAX_KPAD}")
    out = torch.empty((r, kpad), dtype=torch.float32, device=dev)
    if r == 0:
        return out[:, :k]
    zp, dp = _padded(z, kpad), _padded(deltam, kpad)
    launch("eonerf_coarse_fwd", "coarse_forward kernel launch", dev, rayin, zp, dp, weights.mats,
           weights.biases, out, r, kpad)
    coarse_forward.launches += 1
    return out[:, :k]


coarse_forward.launches = 0


def _workspace(camera, r, kpad, dev):
    """The backward kernels' scratch (activations, cotangents and the
    partial sums of the fixed-order gradient reduction), sized by the
    library itself."""
    nbytes = _build.load_library().eonerf_bwd_workspace_bytes(int(camera), r, kpad)
    return torch.empty((nbytes,), dtype=torch.uint8, device=dev)


def camera_backward(weights: KernelWeights, rayin, z, deltam, gacc):
    """VJP of :func:`camera_forward` for the per-ray cotangent ``gacc``
    (R, 8): (d_mats, d_biases) float32 in the packed layout and d_rayin
    (R, 16). CPU tensors: the plain version. CUDA tensors: the hand-written
    bf16 kernels (raises if they cannot be built or launched)."""
    if rayin.device.type == "cpu":
        return camera_backward_reference(weights, rayin, z, deltam, gacc)
    r, k = z.shape
    kpad = kpad_of(k)
    dev = rayin.device
    check_f32("rayin", rayin, (r, RAYIN_COLS), dev)
    check_f32("z", z, (r, k), dev)
    check_f32("deltam", deltam, (r, k), dev)
    check_f32("gacc", gacc, (r, ACC_COLS), dev)
    check_weights(weights, dev)
    if kpad > MAX_KPAD:
        raise ValueError(f"{k} samples per ray exceed the kernel's {MAX_KPAD}")
    d_mats = torch.zeros((MAT_ELEMENTS,), dtype=torch.float32, device=dev)
    d_biases = torch.zeros((BIAS_ELEMENTS,), dtype=torch.float32, device=dev)
    d_rayin = torch.zeros((r, RAYIN_COLS), dtype=torch.float32, device=dev)
    if r == 0:
        return d_mats, d_biases, d_rayin
    zp, dp = _padded(z, kpad), _padded(deltam, kpad)
    launch("eonerf_camera_bwd", "camera_backward kernel launch", dev, rayin, zp, dp, gacc,
           weights.mats, weights.biases, _workspace(True, r, kpad, dev), d_mats, d_biases,
           d_rayin, r, kpad)
    camera_backward.launches += 1
    return d_mats, d_biases, d_rayin


camera_backward.launches = 0


def shadow_backward(weights: KernelWeights, rayin, z, deltam, mask, ggeo):
    """VJP of :func:`shadow_forward` for the per-ray cotangent ``ggeo``
    (R,): (d_mats, d_biases) float32 in the packed layout (zero past the
    density prefix) and d_rayin (R, 16). CPU tensors: the plain version.
    CUDA tensors: the hand-written bf16 kernels (raises if they cannot
    run)."""
    if rayin.device.type == "cpu":
        return shadow_backward_reference(weights, rayin, z, deltam, mask, ggeo)
    r, k = z.shape
    kpad = kpad_of(k)
    dev = rayin.device
    check_f32("rayin", rayin, (r, RAYIN_COLS), dev)
    check_f32("z", z, (r, k), dev)
    check_f32("deltam", deltam, (r, k), dev)
    check_f32("mask", mask, (r, k), dev)
    check_f32("ggeo", ggeo, (r,), dev)
    check_weights(weights, dev)
    if kpad > MAX_KPAD:
        raise ValueError(f"{k} samples per ray exceed the kernel's {MAX_KPAD}")
    d_mats = torch.zeros((MAT_ELEMENTS,), dtype=torch.float32, device=dev)
    d_biases = torch.zeros((BIAS_ELEMENTS,), dtype=torch.float32, device=dev)
    d_rayin = torch.zeros((r, RAYIN_COLS), dtype=torch.float32, device=dev)
    if r == 0:
        return d_mats, d_biases, d_rayin
    zp, dp, mp = _padded(z, kpad), _padded(deltam, kpad), _padded(mask, kpad)
    launch("eonerf_shadow_bwd", "shadow_backward kernel launch", dev, rayin, zp, dp, mp, ggeo,
           weights.mats, weights.biases, _workspace(False, r, kpad, dev), d_mats, d_biases,
           d_rayin, r, kpad)
    shadow_backward.launches += 1
    return d_mats, d_biases, d_rayin


shadow_backward.launches = 0


# ---------------------------------------------------------------------------
# differentiable ops (the JAX package's custom_vjp pairs, recompute mode)
# ---------------------------------------------------------------------------

class _Camera(torch.autograd.Function):
    """Forward saves only its inputs; the backward recomputes."""

    @staticmethod
    def forward(ctx, mats, biases, rayin, z, deltam, dtype):
        kw = KernelWeights(mats.to(dtype), biases)
        ctx.save_for_backward(kw.mats, biases, rayin, z, deltam)
        return camera_forward(kw, rayin, z, deltam)

    @staticmethod
    def backward(ctx, gacc):
        mats, biases, rayin, z, deltam = ctx.saved_tensors
        d_mats, d_biases, d_rayin = camera_backward(KernelWeights(mats, biases), rayin, z,
                                                    deltam, gacc.contiguous())
        return d_mats, d_biases, d_rayin, None, None, None


class _Shadow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mats, biases, rayin, z, deltam, mask, dtype):
        kw = KernelWeights(mats.to(dtype), biases)
        ctx.save_for_backward(kw.mats, biases, rayin, z, deltam, mask)
        return shadow_forward(kw, rayin, z, deltam, mask)

    @staticmethod
    def backward(ctx, ggeo):
        mats, biases, rayin, z, deltam, mask = ctx.saved_tensors
        d_mats, d_biases, d_rayin = shadow_backward(KernelWeights(mats, biases), rayin, z,
                                                    deltam, mask, ggeo.contiguous())
        return d_mats, d_biases, d_rayin, None, None, None, None


def fused_camera(weights: KernelWeights, rayin, z, deltam, compute_dtype):
    """Differentiable camera op. ``weights`` holds the float32 packed
    matrices (cast to ``compute_dtype`` inside, so their gradients arrive in
    float32, as the parameters' own dtype); gradients flow to the weights
    and to ``rayin``, none to z or deltam."""
    return _Camera.apply(weights.mats, weights.biases, rayin, z, deltam, compute_dtype)


def fused_shadow(weights: KernelWeights, rayin, z, deltam, mask, compute_dtype):
    """Differentiable shadow op, as :func:`fused_camera`."""
    return _Shadow.apply(weights.mats, weights.biases, rayin, z, deltam, mask, compute_dtype)


def fused_coarse(weights: KernelWeights, rayin, z, deltam, compute_dtype):
    """The coarse op, forward only: inputs and result cut from autograd (the
    JAX package's ``stop_gradient`` around ``make_fused_coarse``), since the
    hierarchical sampler draws its fine samples under a stop-gradient.
    ``weights`` holds the float32 packed matrices, cast here."""
    with torch.no_grad():
        kw = KernelWeights(weights.mats.detach().to(compute_dtype), weights.biases.detach())
        return coarse_forward(kw, rayin.detach(), z.detach(), deltam.detach())
