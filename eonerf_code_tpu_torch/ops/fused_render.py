"""Fused render ops: field evaluation + volume compositing with per-ray
input and output, forward and backward.

- ``camera_forward(weights, rayin, z, deltam) -> acc (R, 8)`` =
  [depth, albedo r g b, t_s, t_beta, opacity, 0]: the counterpart of the JAX
  package's ``make_fused_camera`` forward (its ``_camera_fwd_kernel``).
- ``shadow_forward(weights, rayin, z, deltam, mask) -> geo (R,)``: the sun
  visibility of the geometric shadow pass, counterpart of
  ``make_fused_shadow`` (``_shadow_fwd_kernel``).
- ``camera_backward`` / ``shadow_backward``: their VJPs (the JAX package's
  ``_camera_bwd_kernel`` / ``_shadow_bwd_kernel``), recomputing the
  forward; float32 weight gradients in the packed layout and per-ray
  d_rayin = [d_o, d_d, d_emb, 0].
- ``fused_camera`` / ``fused_shadow``: the pairs as
  ``torch.autograd.Function``s (the JAX package's ``custom_vjp`` ops).

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

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from eonerf_code_tpu_torch.ops import _build
from eonerf_code_tpu_torch.ops.fused_field import (
    PE_PAD,
    cast_matrices,
    flatten_weights,
    pad_pe_rows,
    unflatten_weights,
)
from eonerf_code_tpu_torch.ops.volrend import exclusive_cumsum

RAYIN_COLS = 16   # [o(3), d(3), emb(4), pad(6)]
ACC_COLS = 8      # [depth, albedo r g b, t_s, t_beta, opacity, pad]
MAX_KPAD = 1024   # the kernels keep every sample of a ray's results in shared memory

# Positions in the 36-entry flat FieldWeights of the matrices and biases, in
# the order the kernels pack them. Trunk + sigma head come first: that
# prefix is all the shadow kernel reads.
_MAT_IDX = (0, 1, 2, 3, 4, 5, 6, 7, 16, 18, 20, 22, 24, 25, 26, 27, 32, 34)
_BIAS_IDX = (8, 9, 10, 11, 12, 13, 14, 15, 17, 19, 21, 23, 28, 29, 30, 31, 33, 35)
# (in, out) of each padded matrix, in _MAT_IDX order (the 8x256 architecture)
_MAT_SHAPES = ((64, 256),) + ((256, 256),) * 4 + ((320, 256),) + ((256, 256),) * 2 + (
    (256, 1), (256, 256), (256, 128), (128, 3), (320, 128), (128, 128), (128, 128),
    (128, 128), (128, 1), (128, 1))
_BIAS_SIZES = (256,) * 8 + (1, 256, 128, 3, 128, 128, 128, 128, 1, 1)
_N_DENSITY_MATS = 9
_N_DENSITY_BIASES = 9
MAT_ELEMENTS = sum(a * b for a, b in _MAT_SHAPES)
BIAS_ELEMENTS = sum(_BIAS_SIZES)
DENSITY_MAT_ELEMENTS = sum(a * b for a, b in _MAT_SHAPES[:_N_DENSITY_MATS])
DENSITY_BIAS_ELEMENTS = sum(_BIAS_SIZES[:_N_DENSITY_BIASES])


class KernelWeights(NamedTuple):
    """The field's per-sample weights packed for the fused kernels: every
    padded matrix transposed to (out, in) and concatenated into ``mats``
    (the compute dtype for the kernel wrappers; float32 for the
    differentiable ops, which cast it); every bias, float32, into
    ``biases``."""

    mats: torch.Tensor
    biases: torch.Tensor

    @property
    def dtype(self):
        return self.mats.dtype


def pack_kernel_weights(w, compute_dtype):
    """FieldWeights (float32, (in, out) matrices) -> KernelWeights."""
    flat = cast_matrices(pad_pe_rows(flatten_weights(w), with_transient=True), compute_dtype)
    mats = [flat[i] for i in _MAT_IDX]
    biases = [flat[i] for i in _BIAS_IDX]
    got = tuple(tuple(m.shape) for m in mats)
    if got != _MAT_SHAPES:
        raise ValueError(f"fused kernels take the 8x256 EO-NeRF field; matrix shapes {got}")
    return KernelWeights(torch.cat([m.t().reshape(-1) for m in mats]).contiguous(),
                         torch.cat([b.reshape(-1).float() for b in biases]).contiguous())


def kernel_views(kw: KernelWeights):
    """KernelWeights -> FieldWeights of views: padded (in, out) matrices in
    the compute dtype, (1, d) float32 biases. The plain versions read it."""
    flat = [None] * 36
    off = 0
    for idx, (n_in, n_out) in zip(_MAT_IDX, _MAT_SHAPES):
        flat[idx] = kw.mats[off:off + n_in * n_out].view(n_out, n_in).t()
        off += n_in * n_out
    off = 0
    for idx, n in zip(_BIAS_IDX, _BIAS_SIZES):
        flat[idx] = kw.biases[off:off + n].view(1, n)
        off += n
    return unflatten_weights(flat)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _pe_lanes(device):
    """Per PE lane: the xyz coordinate it reads and its power-of-two scale
    (0 on the pad lane). Lanes are [x(3) | sin args(30) | cos args(30) | pad],
    degree-major — the JAX package's 64-lane frequency pattern."""
    c = torch.arange(PE_PAD, device=device)
    j = torch.where(c < 3, c, torch.where(c < 33, (c - 3) % 3, (c - 33) % 3))
    deg = torch.where(c < 3, 0, torch.where(c < 33, (c - 3) // 3, (c - 33) // 3))
    scale = torch.where(c < 63, torch.ldexp(torch.ones_like(deg, dtype=torch.float32), deg), 0.0)
    return j, scale


def _pe_args(rayin, z):
    """(R, K, 64) PE arguments xb = o B + (d B) z in float32 (exact for the
    power-of-two B: one nonzero term per lane)."""
    j, scale = _pe_lanes(rayin.device)
    basis_o = rayin[:, 0:3][:, j] * scale
    basis_d = rayin[:, 3:6][:, j] * scale
    return basis_o[:, None, :] + basis_d[:, None, :] * z[:, :, None]


def _pe_from_args(xb, dtype):
    """(R*K, 64) PE of the samples, rounded to ``dtype``. In float32 the cos
    lanes are exact cos; in other dtypes one phased sin(xb + pi/2) serves
    both blocks."""
    col = torch.arange(PE_PAD, device=xb.device)
    if dtype == torch.float32:
        pe = torch.where(col < 3, xb, torch.where(col < 33, torch.sin(xb),
                         torch.where(col < 63, torch.cos(xb), 0.0)))
    else:
        phase = torch.where((col >= 33) & (col < 63), math.pi / 2, 0.0)
        pe = torch.where(col < 3, xb, torch.where(col < 63, torch.sin(xb + phase), 0.0))
    return pe.reshape(-1, PE_PAD).to(dtype)


def _pe_deriv(xb, dtype):
    """(R*K, 64) d(pe)/d(xb) per lane, float32: [1 | cos | -sin | 0]; in
    other dtypes a second phased sin(xb + phase + pi/2), as the kernels."""
    col = torch.arange(PE_PAD, device=xb.device)
    if dtype == torch.float32:
        d = torch.where(col < 3, 1.0, torch.where(col < 33, torch.cos(xb),
                        torch.where(col < 63, -torch.sin(xb), 0.0)))
    else:
        phase = torch.where((col >= 33) & (col < 63), math.pi / 2, 0.0)
        d = torch.where(col < 3, 1.0,
                        torch.where(col < 63, torch.sin(xb + phase + math.pi / 2), 0.0))
    return d.reshape(-1, PE_PAD)


def _pe(rayin, z, dtype):
    return _pe_from_args(_pe_args(rayin, z), dtype)


def _mm(a, w, b=None):
    """a @ w (+ b) in float32: a and w hold compute-dtype values, whose
    products are exact in float32, so this is the kernels' f32-accumulated
    product up to summation order."""
    out = a.float() @ w.float()
    return out if b is None else out + b


def _mm_t(g, w, dtype):
    """g @ w.T with g rounded to ``dtype`` first, accumulated in float32 and
    rounded to ``dtype`` at the output: the cotangent chain stays in the
    compute dtype."""
    return (g.to(dtype).float() @ w.float().t()).to(dtype)


def _outer(a, g):
    """a.T @ g, a weight-gradient contribution: compute-dtype operands,
    float32 accumulation."""
    return a.float().t() @ g.float()


def _colsum(g):
    """Bias gradient: the cotangent summed over samples in float32."""
    return g.float().sum(dim=0, keepdim=True)


def _softplus(x):
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def _trunk(pe, w, dtype):
    """Post-ReLU activations h0..h7 and the ReLU masks (compute dtype)."""
    acts, masks = [], []
    for i in range(8):
        inp = pe if i == 0 else (torch.cat([acts[4], pe], dim=-1) if i == 5 else acts[-1])
        pre = _mm(inp, w.trunk_w[i], w.trunk_b[i])
        acts.append(torch.relu(pre).to(dtype))
        masks.append((pre > 0).to(dtype))
    return acts, masks


def _heads(h, emb64, w, dtype):
    """Per-sample heads from the trunk output: (sigma, albedo, ts, tb) and
    the residuals their backward reads."""
    sig_pre = _mm(h, w.sigma_w, w.sigma_b)
    bott = _mm(h, w.bott_w, w.bott_b).to(dtype)
    ah_pre = _mm(bott, w.alb_w0, w.alb_b0)
    ah = torch.relu(ah_pre).to(dtype)
    albedo = torch.sigmoid(_mm(ah, w.alb_w1, w.alb_b1))
    t_in = torch.cat([bott, emb64.to(dtype)], dim=-1)
    t, t_acts, t_masks = t_in, [], []
    for i in range(4):
        pre = _mm(t, w.tr_w[i], w.tr_b[i])
        t = torch.relu(pre).to(dtype)
        t_acts.append(t)
        t_masks.append((pre > 0).to(dtype))
    ts = torch.sigmoid(_mm(t, w.ts_w, w.ts_b))
    tb_pre = _mm(t, w.tb_w, w.tb_b)
    res = dict(sig_pre=sig_pre, bott=bott, ah_pre=ah_pre, ah=ah, t_in=t_in,
               t_acts=t_acts, t_masks=t_masks, tb_pre=tb_pre)
    return _softplus(sig_pre), albedo, ts, _softplus(tb_pre), res


def _emb64(rayin, r, k):
    emb64 = F.pad(rayin[:, 6:10].float(), (0, PE_PAD - 4))
    return emb64[:, None, :].expand(r, k, PE_PAD).reshape(-1, PE_PAD)


def camera_forward_reference(weights: KernelWeights, rayin, z, deltam):
    """Plain PyTorch version of :func:`camera_forward` (any K, no padding
    needed: padded samples add nothing)."""
    dtype = weights.dtype
    w = kernel_views(weights)
    r, k = z.shape
    z = z.float()
    pe = _pe(rayin.float(), z, dtype)
    sigma, albedo, ts, tb, _ = _heads(_trunk(pe, w, dtype)[0][-1], _emb64(rayin, r, k), w,
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
    sigma = _softplus(_mm(_trunk(pe, w, dtype)[0][-1], w.sigma_w, w.sigma_b)).view(r, k)
    sdelta = sigma * deltam.float()
    return torch.exp(-(sdelta * _before_last(mask)).sum(dim=-1))


def _before_last(mask):
    """1 where a sample lies strictly before its ray's last valid one: the
    count of valid samples from it on (reverse inclusive) is >= 2."""
    remaining = mask.float().flip(-1).cumsum(-1).flip(-1)
    return (remaining >= 2.0).float()


def _pattern(device):
    """(3, 64) float32 B: the scale of each PE lane on the coordinate it reads."""
    j, scale = _pe_lanes(device)
    return torch.zeros((3, PE_PAD), device=device).index_put_(
        (j, torch.arange(PE_PAD, device=device)), scale)


def _reverse_exclusive_cumsum(x):
    """out_i = sum_{j>i} x_j, shifting first (never inclusive minus self)."""
    return exclusive_cumsum(x.flip(-1)).flip(-1)


def _trunk_backward(pe, acts, masks, g_h, w, dtype, dws, dbs):
    """Backward through the trunk from g_h (compute dtype). Fills the weight
    and bias gradients (float32) of the 8 layers; returns d_pe (compute
    dtype): layer 5's PE part plus layer 0's, added in the compute dtype."""
    g_pe = None
    for i in range(7, -1, -1):
        g_pre = g_h * masks[i]
        inp = pe if i == 0 else (torch.cat([acts[4], pe], dim=-1) if i == 5 else acts[i - 1])
        dws[i] = _outer(inp, g_pre)
        dbs[i] = _colsum(g_pre)
        g_in = _mm_t(g_pre, w.trunk_w[i], dtype)
        if i == 5:
            g_h, g_pe = g_in[:, :256], g_in[:, 256:]
        elif i == 0:
            g_pe = g_pe + g_in
        else:
            g_h = g_in
    return g_pe


def _ray_grads(xb, z, g_pe, dtype, r, k):
    """Per-ray d_o, d_d (R, 3) from the PE cotangent: d_xb = g_pe * pe'(xb),
    summed over the ray's samples, routed through the transposed B."""
    d_xb = (g_pe.float() * _pe_deriv(xb, dtype)).view(r, k, PE_PAD)
    pat = _pattern(xb.device)
    return d_xb.sum(dim=1) @ pat.t(), (d_xb * z[..., None]).sum(dim=1) @ pat.t()


def _pack_grads(flat):
    """36 float32 gradients in FieldWeights order, padded (in, out) matrices
    and (1, d) biases -> (mats, biases) in the packed kernel layout."""
    return (torch.cat([flat[i].t().reshape(-1) for i in _MAT_IDX]),
            torch.cat([flat[i].reshape(-1) for i in _BIAS_IDX]))


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
    pe = _pe_from_args(xb, dtype)
    acts, masks = _trunk(pe, w, dtype)
    h = acts[-1]
    sigma, albedo, ts, tb, res = _heads(h, _emb64(rayin, r, k), w, dtype)

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

    # heads backward
    g = [None] * 36
    g_sig_pre = d_sigma * torch.sigmoid(res["sig_pre"])
    g_ts_pre = d_val[:, 4:5] * ts * (1.0 - ts)
    g_tb_pre = d_val[:, 5:6] * torch.sigmoid(res["tb_pre"])
    t_acts, t_masks = res["t_acts"], res["t_masks"]
    g[32], g[33] = _outer(t_acts[3], g_ts_pre.to(dtype)), _colsum(g_ts_pre)
    g[34], g[35] = _outer(t_acts[3], g_tb_pre.to(dtype)), _colsum(g_tb_pre)
    g_t = _mm_t(g_ts_pre, w.ts_w, dtype) + _mm_t(g_tb_pre, w.tb_w, dtype)
    for i in range(3, -1, -1):
        g_pre = g_t * t_masks[i]
        g[24 + i] = _outer(res["t_in"] if i == 0 else t_acts[i - 1], g_pre)
        g[28 + i] = _colsum(g_pre)
        g_t = _mm_t(g_pre, w.tr_w[i], dtype)
    g_emb = g_t[:, 256:260].float()
    g_alb_pre = d_val[:, 1:4] * albedo * (1.0 - albedo)
    g[22], g[23] = _outer(res["ah"], g_alb_pre.to(dtype)), _colsum(g_alb_pre)
    g_ah = (res["ah_pre"] > 0).to(dtype) * _mm_t(g_alb_pre, w.alb_w1, dtype)
    g[20], g[21] = _outer(res["bott"], g_ah), _colsum(g_ah)
    g_bott = g_t[:, :256] + _mm_t(g_ah, w.alb_w0, dtype)
    g[18], g[19] = _outer(h, g_bott), _colsum(g_bott)
    g[16], g[17] = _outer(h, g_sig_pre.to(dtype)), _colsum(g_sig_pre)
    g_h = _mm_t(g_bott, w.bott_w, dtype) + _mm_t(g_sig_pre, w.sigma_w, dtype)

    dws, dbs = [None] * 8, [None] * 8
    g_pe = _trunk_backward(pe, acts, masks, g_h, w, dtype, dws, dbs)
    g[0:8], g[8:16] = dws, dbs
    d_o, d_d = _ray_grads(xb, z, g_pe, dtype, r, k)
    d_emb = g_emb.view(r, k, 4).sum(dim=1)
    d_rayin = torch.cat([d_o, d_d, d_emb, torch.zeros((r, RAYIN_COLS - 10), device=z.device)],
                        dim=1)
    return (*_pack_grads(g), d_rayin)


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
    pe = _pe_from_args(xb, dtype)
    acts, masks = _trunk(pe, w, dtype)
    h = acts[-1]
    sig_pre = _mm(h, w.sigma_w, w.sigma_b)
    before_last = _before_last(mask)
    geo = torch.exp(-(_softplus(sig_pre).view(r, k) * deltam * before_last).sum(dim=-1))
    d_ev = -geo * ggeo.float().reshape(-1)
    d_sigma = (d_ev[:, None] * before_last * deltam).reshape(-1, 1)
    g_sig_pre = d_sigma * torch.sigmoid(sig_pre)

    dws, dbs = [None] * 8, [None] * 8
    g_h = _mm_t(g_sig_pre, w.sigma_w, dtype)
    g_pe = _trunk_backward(pe, acts, masks, g_h, w, dtype, dws, dbs)
    full = flatten_weights(w)
    g = [torch.zeros(x.shape, device=z.device) for x in full]
    g[0:8], g[8:16] = dws, dbs
    g[16], g[17] = _outer(h, g_sig_pre.to(dtype)), _colsum(g_sig_pre)
    d_o, d_d = _ray_grads(xb, z, g_pe, dtype, r, k)
    d_rayin = torch.cat([d_o, d_d, torch.zeros((r, RAYIN_COLS - 6), device=z.device)], dim=1)
    return (*_pack_grads(g), d_rayin)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def kpad_of(k):
    """Samples padded to a multiple of 8 (the kernels' tile rows)."""
    return ((max(k, 1) + 7) // 8) * 8


def _check_f32(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_weights(weights: KernelWeights, device):
    if weights.mats.device != device or weights.biases.device != device:
        raise ValueError(f"weights must be on {device}")
    if weights.mats.dtype != torch.bfloat16 or weights.biases.dtype != torch.float32:
        raise TypeError("the CUDA kernels take bfloat16 matrices and float32 biases, got "
                        f"{weights.mats.dtype} / {weights.biases.dtype}")
    if (weights.mats.shape, weights.biases.shape) != ((MAT_ELEMENTS,), (BIAS_ELEMENTS,)):
        raise ValueError("packed weights have the wrong size for the 8x256 field")
    if not (weights.mats.is_contiguous() and weights.biases.is_contiguous()):
        raise ValueError("packed weights must be contiguous")
    if weights.mats.data_ptr() % 16:
        raise ValueError("packed matrices must be 16-byte aligned")
    if _build.kernel_weight_layout() != (MAT_ELEMENTS, BIAS_ELEMENTS,
                                         DENSITY_MAT_ELEMENTS, DENSITY_BIAS_ELEMENTS):
        raise RuntimeError("the compiled kernels index another weight layout than this module")


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
    _check_f32("rayin", rayin, (r, RAYIN_COLS), dev)
    _check_f32("z", z, (r, k), dev)
    _check_f32("deltam", deltam, (r, k), dev)
    _check_weights(weights, dev)
    if kpad > MAX_KPAD:
        raise ValueError(f"{k} samples per ray exceed the kernel's {MAX_KPAD}")
    acc = torch.empty((r, ACC_COLS), dtype=torch.float32, device=dev)
    if r == 0:
        return acc
    zp, dp = _padded(z, kpad), _padded(deltam, kpad)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.eonerf_camera_fwd(rayin.data_ptr(), zp.data_ptr(), dp.data_ptr(),
                                     weights.mats.data_ptr(), weights.biases.data_ptr(),
                                     acc.data_ptr(), r, kpad, stream)
    _build.check(code, "camera_forward kernel launch")
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
    _check_f32("rayin", rayin, (r, RAYIN_COLS), dev)
    _check_f32("z", z, (r, k), dev)
    _check_f32("deltam", deltam, (r, k), dev)
    _check_f32("mask", mask, (r, k), dev)
    _check_weights(weights, dev)
    if kpad > MAX_KPAD:
        raise ValueError(f"{k} samples per ray exceed the kernel's {MAX_KPAD}")
    geo = torch.empty((r,), dtype=torch.float32, device=dev)
    if r == 0:
        return geo
    zp, dp, mp = _padded(z, kpad), _padded(deltam, kpad), _padded(mask, kpad)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.eonerf_shadow_fwd(rayin.data_ptr(), zp.data_ptr(), dp.data_ptr(),
                                     mp.data_ptr(), weights.mats.data_ptr(),
                                     weights.biases.data_ptr(), geo.data_ptr(), r, kpad,
                                     stream)
    _build.check(code, "shadow_forward kernel launch")
    shadow_forward.launches += 1
    return geo


shadow_forward.launches = 0


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
    _check_f32("rayin", rayin, (r, RAYIN_COLS), dev)
    _check_f32("z", z, (r, k), dev)
    _check_f32("deltam", deltam, (r, k), dev)
    _check_f32("gacc", gacc, (r, ACC_COLS), dev)
    _check_weights(weights, dev)
    if kpad > MAX_KPAD:
        raise ValueError(f"{k} samples per ray exceed the kernel's {MAX_KPAD}")
    d_mats = torch.zeros((MAT_ELEMENTS,), dtype=torch.float32, device=dev)
    d_biases = torch.zeros((BIAS_ELEMENTS,), dtype=torch.float32, device=dev)
    d_rayin = torch.zeros((r, RAYIN_COLS), dtype=torch.float32, device=dev)
    if r == 0:
        return d_mats, d_biases, d_rayin
    zp, dp = _padded(z, kpad), _padded(deltam, kpad)
    ws = _workspace(True, r, kpad, dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.eonerf_camera_bwd(rayin.data_ptr(), zp.data_ptr(), dp.data_ptr(),
                                     gacc.data_ptr(), weights.mats.data_ptr(),
                                     weights.biases.data_ptr(), ws.data_ptr(),
                                     d_mats.data_ptr(), d_biases.data_ptr(),
                                     d_rayin.data_ptr(), r, kpad, stream)
    _build.check(code, "camera_backward kernel launch")
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
    _check_f32("rayin", rayin, (r, RAYIN_COLS), dev)
    _check_f32("z", z, (r, k), dev)
    _check_f32("deltam", deltam, (r, k), dev)
    _check_f32("mask", mask, (r, k), dev)
    _check_f32("ggeo", ggeo, (r,), dev)
    _check_weights(weights, dev)
    if kpad > MAX_KPAD:
        raise ValueError(f"{k} samples per ray exceed the kernel's {MAX_KPAD}")
    d_mats = torch.zeros((MAT_ELEMENTS,), dtype=torch.float32, device=dev)
    d_biases = torch.zeros((BIAS_ELEMENTS,), dtype=torch.float32, device=dev)
    d_rayin = torch.zeros((r, RAYIN_COLS), dtype=torch.float32, device=dev)
    if r == 0:
        return d_mats, d_biases, d_rayin
    zp, dp, mp = _padded(z, kpad), _padded(deltam, kpad), _padded(mask, kpad)
    ws = _workspace(False, r, kpad, dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.eonerf_shadow_bwd(rayin.data_ptr(), zp.data_ptr(), dp.data_ptr(),
                                     mp.data_ptr(), ggeo.data_ptr(), weights.mats.data_ptr(),
                                     weights.biases.data_ptr(), ws.data_ptr(),
                                     d_mats.data_ptr(), d_biases.data_ptr(),
                                     d_rayin.data_ptr(), r, kpad, stream)
    _build.check(code, "shadow_backward kernel launch")
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
