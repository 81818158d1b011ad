"""Fused render forward ops: field evaluation + volume compositing with
per-ray input and output.

- ``camera_forward(weights, rayin, z, deltam) -> acc (R, 8)`` =
  [depth, albedo r g b, t_s, t_beta, opacity, 0]: the counterpart of the JAX
  package's ``make_fused_camera`` forward (its ``_camera_fwd_kernel``).
- ``shadow_forward(weights, rayin, z, deltam, mask) -> geo (R,)``: the sun
  visibility of the geometric shadow pass, counterpart of
  ``make_fused_shadow`` (``_shadow_fwd_kernel``).

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
    padded matrix transposed to (out, in), cast to the compute dtype and
    concatenated into ``mats``; every bias, float32, into ``biases``."""

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


def _pe(rayin, z, dtype):
    """(R*K, 64) PE of the samples o + d z, built as xb = o B + (d B) z in
    float32 (exact for the power-of-two B: one nonzero term per lane). In
    float32 the cos lanes are exact cos; in other dtypes one phased
    sin(xb + pi/2) serves both blocks. Rounded to ``dtype``."""
    j, scale = _pe_lanes(rayin.device)
    basis_o = rayin[:, 0:3][:, j] * scale
    basis_d = rayin[:, 3:6][:, j] * scale
    xb = basis_o[:, None, :] + basis_d[:, None, :] * z[:, :, None]
    col = torch.arange(PE_PAD, device=rayin.device)
    if dtype == torch.float32:
        pe = torch.where(col < 3, xb, torch.where(col < 33, torch.sin(xb),
                         torch.where(col < 63, torch.cos(xb), 0.0)))
    else:
        phase = torch.where((col >= 33) & (col < 63), math.pi / 2, 0.0)
        pe = torch.where(col < 3, xb, torch.where(col < 63, torch.sin(xb + phase), 0.0))
    return pe.reshape(-1, PE_PAD).to(dtype)


def _mm(a, w, b=None):
    """a @ w (+ b) in float32: a and w hold compute-dtype values, whose
    products are exact in float32, so this is the kernels' f32-accumulated
    product up to summation order."""
    out = a.float() @ w.float()
    return out if b is None else out + b


def _softplus(x):
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def _trunk(pe, w, dtype):
    h = torch.relu(_mm(pe, w.trunk_w[0], w.trunk_b[0])).to(dtype)
    for i in range(1, 8):
        inp = torch.cat([h, pe], dim=-1) if i == 5 else h
        h = torch.relu(_mm(inp, w.trunk_w[i], w.trunk_b[i])).to(dtype)
    return h


def _heads(h, emb64, w, dtype):
    sigma = _softplus(_mm(h, w.sigma_w, w.sigma_b))
    bott = _mm(h, w.bott_w, w.bott_b).to(dtype)
    ah = torch.relu(_mm(bott, w.alb_w0, w.alb_b0)).to(dtype)
    albedo = torch.sigmoid(_mm(ah, w.alb_w1, w.alb_b1))
    t = torch.cat([bott, emb64.to(dtype)], dim=-1)
    for i in range(4):
        t = torch.relu(_mm(t, w.tr_w[i], w.tr_b[i])).to(dtype)
    ts = torch.sigmoid(_mm(t, w.ts_w, w.ts_b))
    tb = _softplus(_mm(t, w.tb_w, w.tb_b))
    return sigma, albedo, ts, tb


def camera_forward_reference(weights: KernelWeights, rayin, z, deltam):
    """Plain PyTorch version of :func:`camera_forward` (any K, no padding
    needed: padded samples add nothing)."""
    dtype = weights.dtype
    w = kernel_views(weights)
    r, k = z.shape
    z = z.float()
    pe = _pe(rayin.float(), z, dtype)
    emb64 = F.pad(rayin[:, 6:10].float(), (0, PE_PAD - 4))
    emb64 = emb64[:, None, :].expand(r, k, PE_PAD).reshape(-1, PE_PAD)
    sigma, albedo, ts, tb = _heads(_trunk(pe, w, dtype), emb64, w, dtype)
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
    sigma = _softplus(_mm(_trunk(pe, w, dtype), w.sigma_w, w.sigma_b)).view(r, k)
    sdelta = sigma * deltam.float()
    # a sample counts when it lies strictly before the ray's last valid one:
    # the count of valid samples from it on (reverse inclusive) is >= 2
    maskf = mask.float()
    remaining = maskf.flip(-1).cumsum(-1).flip(-1)
    return torch.exp(-(sdelta * (remaining >= 2.0)).sum(dim=-1))


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
