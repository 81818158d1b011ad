"""Kernel-ready views of the EO-NeRF field's per-sample parameters, the
pieces of the field every fused kernel shares, and the per-point density
op.

The counterpart of the JAX package's ops/pallas/fused_field.py. Matrices
keep the JAX package's (in, out) layout, biases are (1, d) rows, so
:class:`FieldWeights` compares one to one with the JAX ``FieldWeights``.
Every packing step is differentiable: gradients reach the field's
parameters through the packing, and the rows that ``pad_pe_rows`` adds drop
out of them again (``unpad_pe_rows`` is the same cut, for gradients held in
padded form).

- :class:`KernelWeights` / :func:`pack_kernel_weights`: the packed layout
  every CUDA kernel of csrc/fused_render.cu reads.
- ``density_forward(weights, pos) -> sigma (N,)``: per-point density, the
  counterpart of ``make_fused_density``'s forward (its
  ``_density_fwd_kernel``); ``fused_density`` is the op, whose backward
  (the JAX package's ``_density_bwd_kernel``) is not ported yet and raises.

The per-point full field (``make_fused_field``) is not part of the port
yet.
"""

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from eonerf_code_tpu_torch.ops import _build

POS_DEG = 10               # positional encoding degrees
PE_DIM = 3 + 6 * POS_DEG   # 63
PE_PAD = 64                # the kernels' PE width: 63 lanes + one zero lane
N_WEIGHTS = 36
N_DENSITY_WEIGHTS = 18     # trunk (8 + 8) + sigma head (2)


class FieldWeights(NamedTuple):
    """Flat view of the EONerfField per-sample parameters."""

    trunk_w: tuple  # 8 matrices; layer 5 takes the skip concat (319, 256)
    trunk_b: tuple  # 8 x (1, 256)
    sigma_w: torch.Tensor  # (256, 1)
    sigma_b: torch.Tensor  # (1, 1)
    bott_w: torch.Tensor   # (256, 256)
    bott_b: torch.Tensor   # (1, 256)
    alb_w0: torch.Tensor   # (256, 128)
    alb_b0: torch.Tensor   # (1, 128)
    alb_w1: torch.Tensor   # (128, 3)
    alb_b1: torch.Tensor   # (1, 3)
    tr_w: tuple  # 4 matrices; the first is (260, 128)
    tr_b: tuple  # 4 x (1, 128)
    ts_w: torch.Tensor     # (128, 1)
    ts_b: torch.Tensor     # (1, 1)
    tb_w: torch.Tensor     # (128, 1)
    tb_b: torch.Tensor     # (1, 1)


def pack_params(field):
    """EONerfField -> FieldWeights (float32 views of the parameters, on the
    field's device; differentiable)."""

    def wb(mlp, name):
        layer = getattr(mlp, name)
        return layer.weight.t(), layer.bias.reshape(1, -1)

    trunk_w, trunk_b = zip(*(wb(field.trunk, f"hidden_{i}") for i in range(8)))
    sigma_w, sigma_b = wb(field.sigma_head, "output")
    bott_w, bott_b = wb(field.bottleneck, "output")
    alb_w0, alb_b0 = wb(field.albedo_mlp, "hidden_0")
    alb_w1, alb_b1 = wb(field.albedo_mlp, "output")
    tr_w, tr_b = zip(*(wb(field.transient_mlp, f"hidden_{i}") for i in range(4)))
    ts_w, ts_b = wb(field.transient_scalar, "output")
    tb_w, tb_b = wb(field.transient_beta, "output")
    return FieldWeights(tuple(trunk_w), tuple(trunk_b), sigma_w, sigma_b,
                        bott_w, bott_b, alb_w0, alb_b0, alb_w1, alb_b1,
                        tuple(tr_w), tuple(tr_b), ts_w, ts_b, tb_w, tb_b)


def flatten_weights(w: FieldWeights):
    return [*w.trunk_w, *w.trunk_b, w.sigma_w, w.sigma_b, w.bott_w, w.bott_b,
            w.alb_w0, w.alb_b0, w.alb_w1, w.alb_b1, *w.tr_w, *w.tr_b,
            w.ts_w, w.ts_b, w.tb_w, w.tb_b]


def unflatten_weights(flat):
    it = list(flat)
    return FieldWeights(tuple(it[0:8]), tuple(it[8:16]), it[16], it[17],
                        it[18], it[19], it[20], it[21], it[22], it[23],
                        tuple(it[24:28]), tuple(it[28:32]), it[32], it[33],
                        it[34], it[35])


def density_subset(w: FieldWeights):
    return [*w.trunk_w, *w.trunk_b, w.sigma_w, w.sigma_b]


def is_bias(x):
    return x.dim() == 2 and x.shape[0] == 1


def cast_matrices(flat, dtype):
    """Weight MATRICES to the compute dtype; biases stay float32 (they are
    added to float32 accumulators)."""
    return [x if is_bias(x) else x.to(dtype) for x in flat]


def pad_pe_rows(flat, with_transient=False):
    """Zero-pad trunk W0 (63 -> 64 rows), W5 (319 -> 320 rows) and, for the
    full field, transient W0 (260 -> 320 rows, matching the 64-wide padded
    embedding block) so every kernel operand has an aligned width."""
    out = list(flat)
    out[0] = F.pad(out[0], (0, 0, 0, 1))
    out[5] = F.pad(out[5], (0, 0, 0, 1))
    if with_transient:
        out[24] = F.pad(out[24], (0, 0, 0, 60))
    return out


def unpad_pe_rows(flat, with_transient=False):
    """Inverse of :func:`pad_pe_rows` (for weight gradients in padded form)."""
    out = list(flat)
    out[0] = out[0][:PE_DIM]
    out[5] = out[5][:256 + PE_DIM]
    if with_transient:
        out[24] = out[24][:260]
    return out


# ---------------------------------------------------------------------------
# the packed layout of the CUDA kernels
# ---------------------------------------------------------------------------

# Positions in the 36-entry flat FieldWeights of the matrices and biases, in
# the order the kernels pack them. Trunk + sigma head come first: that
# prefix is all the shadow, coarse and density kernels read.
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
# the plain field pieces the kernels' plain versions share
# ---------------------------------------------------------------------------

def pe_lanes(device):
    """Per PE lane: the xyz coordinate it reads and its power-of-two scale
    (0 on the pad lane). Lanes are [x(3) | sin args(30) | cos args(30) | pad],
    degree-major — the JAX package's 64-lane frequency pattern."""
    c = torch.arange(PE_PAD, device=device)
    j = torch.where(c < 3, c, torch.where(c < 33, (c - 3) % 3, (c - 33) % 3))
    deg = torch.where(c < 3, 0, torch.where(c < 33, (c - 3) // 3, (c - 33) // 3))
    scale = torch.where(c < 63, torch.ldexp(torch.ones_like(deg, dtype=torch.float32), deg), 0.0)
    return j, scale


def pe_from_args(xb, dtype):
    """(M, 64) PE of the points, rounded to ``dtype``. In float32 the cos
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


def mm(a, w, b=None):
    """a @ w (+ b) in float32: a and w hold compute-dtype values, whose
    products are exact in float32, so this is the kernels' f32-accumulated
    product up to summation order."""
    out = a.float() @ w.float()
    return out if b is None else out + b


def softplus(x):
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def trunk(pe, w, dtype):
    """Post-ReLU activations h0..h7 and the ReLU masks (compute dtype)."""
    acts, masks = [], []
    for i in range(8):
        inp = pe if i == 0 else (torch.cat([acts[4], pe], dim=-1) if i == 5 else acts[-1])
        pre = mm(inp, w.trunk_w[i], w.trunk_b[i])
        acts.append(torch.relu(pre).to(dtype))
        masks.append((pre > 0).to(dtype))
    return acts, masks


def density_forward_reference(weights: KernelWeights, pos):
    """Plain PyTorch version of :func:`density_forward`: PE from the points
    themselves (xb = x 2^deg, exact in float32: the ray form with d = 0,
    z = 0), the trunk and the sigma head."""
    dtype = weights.dtype
    w = kernel_views(weights)
    j, scale = pe_lanes(pos.device)
    pe = pe_from_args(pos.float()[:, j] * scale, dtype)
    return softplus(mm(trunk(pe, w, dtype)[0][-1], w.sigma_w, w.sigma_b))[:, 0]


# ---------------------------------------------------------------------------
# wrapper checks shared by every kernel
# ---------------------------------------------------------------------------

def check_f32(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_weights(weights: KernelWeights, device):
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


# ---------------------------------------------------------------------------
# the density kernel's wrapper and op
# ---------------------------------------------------------------------------

def density_forward(weights: KernelWeights, pos):
    """Per-point density (N,) for points (N, 3). CPU tensors: the plain
    version. CUDA tensors: the hand-written bf16 kernel (raises if it cannot
    be built or launched)."""
    if pos.device.type == "cpu":
        return density_forward_reference(weights, pos)
    n = pos.shape[0]
    dev = pos.device
    check_f32("pos", pos, (n, 3), dev)
    check_weights(weights, dev)
    sigma = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return sigma
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.eonerf_density_fwd(pos.data_ptr(), weights.mats.data_ptr(),
                                      weights.biases.data_ptr(), sigma.data_ptr(), n, stream)
    _build.check(code, "density_forward kernel launch")
    density_forward.launches += 1
    return sigma


density_forward.launches = 0


class _Density(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mats, biases, pos, dtype):
        return density_forward(KernelWeights(mats.to(dtype), biases), pos)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the density op's backward (the JAX package's _density_bwd_kernel, row 9 of "
            "PERF.md's kernel table) is not ported yet; no path of the port differentiates "
            "through it")


def fused_density(weights: KernelWeights, pos, compute_dtype):
    """Density op over float32 packed weights (cast to ``compute_dtype``
    inside). Forward only: a gradient that reaches it raises instead of
    being dropped."""
    return _Density.apply(weights.mats, weights.biases, pos.float().contiguous(), compute_dtype)
