"""Kernel-ready views of the EO-NeRF field's per-sample parameters, the
pieces of the field every fused kernel shares, and the per-point field and
density ops.

The counterpart of the JAX package's ops/pallas/fused_field.py. Matrices
keep the JAX package's (in, out) layout, biases are (1, d) rows, so
:class:`FieldWeights` compares one to one with the JAX ``FieldWeights``.
Every packing step is differentiable: gradients reach the field's
parameters through the packing, and the rows that ``pad_pe_rows`` adds drop
out of them again (``unpad_pe_rows`` is the same cut, for gradients held in
padded form).

- :class:`KernelWeights` / :func:`pack_kernel_weights`: the packed layout
  every CUDA kernel of csrc/fused_render.cu reads.
- ``field_forward(weights, pos, emb) -> (N, 8)`` = [sigma, albedo r g b,
  t_s, t_beta, 0, 0]: the per-point full field, the counterpart of
  ``make_fused_field``'s forward (its ``_field_fwd_kernel``);
  ``field_backward`` its VJP (``_field_bwd_kernel``): float32 weight
  gradients in the packed layout, per-point d_pos and d_emb.
- ``density_forward(weights, pos) -> sigma (N,)`` and ``density_backward``:
  per-point density and its VJP, the counterparts of
  ``make_fused_density`` (``_density_fwd_kernel``, ``_density_bwd_kernel``;
  the heads get exact zeros).
- the int8 trunk tier's plain pieces (``quantize_trunk_int8``,
  :class:`Q8Weights`, ``q8_act``, ``mm_q8``, ``trunk_q8``,
  ``trunk_backward_q8``), which the ray ops of ops/fused_render.py use.
- ``fused_field`` / ``fused_density``: the pairs as
  ``torch.autograd.Function``s in recompute mode (the JAX package's
  ``custom_vjp`` ops).

Each wrapper takes its plain PyTorch version (``*_reference``) only for
tensors on the CPU; for CUDA tensors it launches the hand-written kernel or
raises, and counts its launches in its ``launches`` attribute.
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
FIELD_COLS = 8             # per-point field output: [sigma, albedo r g b, t_s, t_beta, 0, 0]
EMB_DIM = 4                # the transient embedding's width


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


def pe_pattern(device):
    """(3, 64) float32 B: the scale of each PE lane on the coordinate it reads."""
    j, scale = pe_lanes(device)
    return torch.zeros((3, PE_PAD), device=device).index_put_(
        (j, torch.arange(PE_PAD, device=device)), scale)


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


def pe_deriv(xb, dtype):
    """(M, 64) d(pe)/d(xb) per lane, float32: [1 | cos | -sin | 0]; in
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


def point_pe_args(pos):
    """(N, 64) PE arguments of points (N, 3): xb = x 2^deg, exact in float32
    (the ray form with d = 0, z = 0)."""
    j, scale = pe_lanes(pos.device)
    return pos.float()[:, j] * scale


def point_grads(xb, g_pe, dtype):
    """d_pos (N, 3) from the PE cotangent: d_xb = g_pe * pe'(xb) routed
    through the transposed B."""
    return (g_pe.float() * pe_deriv(xb, dtype)) @ pe_pattern(xb.device).t()


def mm(a, w, b=None):
    """a @ w (+ b) in float32: a and w hold compute-dtype values, whose
    products are exact in float32, so this is the kernels' f32-accumulated
    product up to summation order."""
    out = a.float() @ w.float()
    return out if b is None else out + b


def mm_t(g, w, dtype):
    """g @ w.T with g rounded to ``dtype`` first, accumulated in float32 and
    rounded to ``dtype`` at the output: the cotangent chain stays in the
    compute dtype."""
    return (g.to(dtype).float() @ w.float().t()).to(dtype)


def outer(a, g):
    """a.T @ g, a weight-gradient contribution: compute-dtype operands,
    float32 accumulation."""
    return a.float().t() @ g.float()


def colsum(g):
    """Bias gradient: the cotangent summed over samples in float32."""
    return g.float().sum(dim=0, keepdim=True)


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


def trunk_backward(pe, acts, masks, g_h, w, dtype, g):
    """Backward through the trunk from g_h (compute dtype). Fills the float32
    weight and bias gradients of the 8 layers into entries 0-15 of ``g``
    (FieldWeights order); returns d_pe (compute dtype): layer 5's PE part
    plus layer 0's, added in the compute dtype."""
    g_pe = None
    for i in range(7, -1, -1):
        g_pre = g_h * masks[i]
        inp = pe if i == 0 else (torch.cat([acts[4], pe], dim=-1) if i == 5 else acts[i - 1])
        g[i], g[8 + i] = outer(inp, g_pre), colsum(g_pre)
        g_in = mm_t(g_pre, w.trunk_w[i], dtype)
        if i == 5:
            g_h, g_pe = g_in[:, :256], g_in[:, 256:]
        elif i == 0:
            g_pe = g_pe + g_in
        else:
            g_h = g_in
    return g_pe


# ---------------------------------------------------------------------------
# the int8 trunk tier (trunk_quant "int8" / "int8_full"): per-column weight
# scales, dynamic activation scales per scale group, int8 x int8 products
# with int32 accumulation. The counterpart of the JAX package's
# quantize_trunk_int8, _q8_act, _mm_q8, _trunk_fwd_q8 and _trunk_bwd_q8.
#
# A scale group is the rows one TPU grid step holds: rt rays x KPAD samples
# of the padded call, padded samples and zero rays included. The plain
# versions here take the group's row count and reduce over each group; every
# product of integers they form is exact (float32 below 2^24, float64 for
# the weight gradients' sums over a group), so only the dequantization
# rounds, at the JAX package's points and in its order.
# ---------------------------------------------------------------------------

N_Q8 = 16   # 8 int8 trunk matrices + 8 (1, 256) float32 per-column scale rows
TRUNK_MAT_ELEMENTS = sum(a * b for a, b in _MAT_SHAPES[:8])
TRUNK_BIAS_ELEMENTS = 8 * 256
Q8_POINTS = 8   # activation quantizations per group: the PE, then h0..h6


def quantize_trunk_int8(flat_padded_f32):
    """Symmetric per-column int8 quantization of the 8 padded float32 trunk
    matrices ((in, out), the JAX layout): s = max(max_rows |w|, 1e-12) / 127,
    w8 = round(w / s), half to even. Returns [w8 x8] + [scale (1, out) x8]."""
    w8s, scales = [], []
    for wmat in flat_padded_f32[:8]:
        wf = wmat.float()
        s = torch.clamp(wf.abs().amax(dim=0, keepdim=True), min=1e-12) / 127.0
        w8s.append(torch.round(wf / s).to(torch.int8))
        scales.append(s)
    return w8s + scales


class Q8Weights(NamedTuple):
    """The int8 trunk for the kernels: ``w8`` the 8 quantized matrices
    packed as the trunk prefix of ``KernelWeights.mats`` ((out, in) each),
    ``w8t`` the same matrices transposed ((in, out) each, the dgrad
    operand), ``scales`` the 8 x 256 float32 per-column weight scales."""

    w8: torch.Tensor
    w8t: torch.Tensor
    scales: torch.Tensor


def quantize_kernel_trunk(mats_f32):
    """Q8Weights from float32 packed matrices (the prefix holding the trunk):
    :func:`quantize_trunk_int8` on each matrix, packed. Glue, run on every
    call from the current weights, as the JAX package does."""
    mats_f32 = mats_f32.detach().float()
    w8, w8t, scales, off = [], [], [], 0
    for n_in, n_out in _MAT_SHAPES[:8]:
        q, s = quantize_trunk_int8([mats_f32[off:off + n_in * n_out].view(n_out, n_in).t()])
        w8.append(q.t().reshape(-1))     # (out, in)
        w8t.append(q.reshape(-1))        # (in, out)
        scales.append(s.reshape(-1))
        off += n_in * n_out
    return Q8Weights(torch.cat(w8).contiguous(), torch.cat(w8t).contiguous(),
                     torch.cat(scales).contiguous())


def q8_views(q8: Q8Weights):
    """Q8Weights -> ([w8 (in, out) x8] as float32 integer values,
    [scale (1, 256) x8]): the plain versions' operands."""
    w8s, off = [], 0
    for n_in, n_out in _MAT_SHAPES[:8]:
        w8s.append(q8.w8t[off:off + n_in * n_out].view(n_in, n_out).float())
        off += n_in * n_out
    return w8s, [q8.scales[256 * i:256 * (i + 1)].view(1, 256) for i in range(8)]


def q8_act(x, group_rows):
    """Dynamic symmetric int8 quantization of float32 ``x`` (M, C), one scale
    per group of ``group_rows`` rows: inv = 127 / max(amax, 1e-12),
    x8 = round(x inv), scale 1 / inv. Returns (x8 as float32 integer
    values, scale per group (G, 1), amax per group (G,))."""
    m = x.shape[0]
    amax = x.abs().reshape(m // group_rows, -1).amax(dim=1)
    # tensor / tensor: a Python number over a tensor would round twice
    # (PyTorch takes the reciprocal, then multiplies)
    inv = torch.full_like(amax, 127.0) / torch.clamp(amax, min=1e-12)
    x8 = torch.round(x * inv.repeat_interleave(group_rows)[:, None])
    return x8, (torch.ones_like(inv) / inv)[:, None], amax


def _rows(s_group, group_rows):
    return s_group.repeat_interleave(group_rows, dim=0)


def mm_q8(h8, w8, sw_row, s_rows, b=None):
    """int8 x int8 product with int32 accumulation (exact in float32 here:
    at most 320 terms of |v| <= 127^2), dequantized as acc * (s_w s_act)
    (+ b)."""
    out = (h8 @ w8) * (sw_row * s_rows)
    return out if b is None else out + b


def trunk_q8(pe, w, q8: Q8Weights, dtype, group_rows):
    """The int8 trunk: post-ReLU activations h0..h7 rounded to ``dtype``, the
    ReLU masks from the float32 pre-activations, and the amax of every
    quantization per group (G, 8): the PE, then h0..h6. The running
    activation stays float32 between layers; the skip layer quantizes h4 and
    the PE separately (two products, (A + B) + b)."""
    w8s, sws = q8_views(q8)
    pe8, pe_s, amax0 = q8_act(pe.float(), group_rows)
    pe_s = _rows(pe_s, group_rows)
    acts, masks, amax = [], [], [amax0]
    for i in range(8):
        if i == 0:
            pre = mm_q8(pe8, w8s[0], sws[0], pe_s, w.trunk_b[0])
        else:
            h8, sa, a = q8_act(hf, group_rows)
            amax.append(a)
            sa = _rows(sa, group_rows)
            if i == 5:
                pre = (mm_q8(h8, w8s[5][:256], sws[5], sa)
                       + mm_q8(pe8, w8s[5][256:], sws[5], pe_s)) + w.trunk_b[5]
            else:
                pre = mm_q8(h8, w8s[i], sws[i], sa, w.trunk_b[i])
        hf = torch.relu(pre)
        acts.append(hf.to(dtype))
        masks.append((pre > 0).to(dtype))
    return acts, masks, torch.stack(amax, dim=1)


def _wgrad_q8(a8, g8, s_in, col_s, group_rows):
    """sum over groups, in group order, of (a8_g^T g8_g) * (s_in_g col_s_g):
    each group's exact integer product (float64), rounded to float32 as the
    int32 sum converts, scaled, then added to the running float32 total."""
    n_g = a8.shape[0] // group_rows
    acc = torch.bmm(a8.view(n_g, group_rows, -1).double().transpose(1, 2),
                    g8.view(n_g, group_rows, -1).double()).float()
    contrib = acc * (s_in * col_s)[:, None, :]
    total = contrib[0]
    for j in range(1, n_g):
        total = total + contrib[j]
    return total


def trunk_chain_q8(masks, g_h, q8: Q8Weights, dtype, g, group_rows):
    """The int8_full trunk backward's cotangent chain from g_h (compute
    dtype): per layer the masked cotangent gf's bias gradient (entries 8-15
    of ``g``, float32), one quantization of the weight-scale-folded gf * s_w
    per group, g8, and dgrad, (g8 w8^T) s_g rounded to ``dtype``. Returns
    (d_pe in ``dtype``, the cotangent amax per group and layer (G, 8), each
    layer's g8 (rows, 256; integer values in float32), each layer's column
    scale s_g / s_w (G, 256))."""
    w8s, sws = q8_views(q8)
    g_pe, gamax, g8s, col_ss = None, [None] * 8, [None] * 8, [None] * 8
    for i in range(7, -1, -1):
        gf = (g_h * masks[i]).float()
        g[8 + i] = colsum(gf)
        g8s[i], s_g, gamax[i] = q8_act(gf * sws[i], group_rows)
        col_ss[i] = s_g / sws[i]
        g_in = ((g8s[i] @ w8s[i].t()) * _rows(s_g, group_rows)).to(dtype)
        if i == 5:
            g_h, g_pe = g_in[:, :256], g_in[:, 256:]
        elif i == 0:
            g_pe = g_pe + g_in
        else:
            g_h = g_in
    return g_pe, torch.stack(gamax, dim=1), g8s, col_ss


def trunk_wgrad_q8(pe, acts, g8s, col_ss, g, group_rows):
    """The int8_full trunk's weight gradients (entries 0-7 of ``g``) from
    :func:`trunk_chain_q8`'s g8 and column scales: per layer and group
    (inp8^T g8) s_in s_g / s_w, summed in group order, inp8 the quantized
    compute-dtype activation (or the PE)."""
    pe8, pe_s, _ = q8_act(pe.float(), group_rows)
    for i in range(8):
        if i == 0:
            g[0] = _wgrad_q8(pe8, g8s[0], pe_s, col_ss[0], group_rows)
            continue
        h8, s_h, _ = q8_act(acts[i - 1].float(), group_rows)
        g[i] = _wgrad_q8(h8, g8s[i], s_h, col_ss[i], group_rows)
        if i == 5:
            g[5] = torch.cat([g[5], _wgrad_q8(pe8, g8s[5], pe_s, col_ss[5], group_rows)], dim=0)


def trunk_backward_q8(pe, acts, masks, g_h, q8: Q8Weights, dtype, g, group_rows):
    """The int8_full trunk backward from g_h (compute dtype): per layer one
    quantization of the weight-scale-folded cotangent gf * s_w per group
    serves dgrad, (g8 w8^T) s_g rounded to ``dtype``, and wgrad,
    (inp8^T g8) s_in s_g / s_w per group, inp8 the quantized compute-dtype
    activation (or the PE). Bias gradients sum the unquantized float32
    cotangent. Fills entries 0-15 of ``g``; returns (d_pe in ``dtype``, the
    cotangent amax per group and layer (G, 8)): :func:`trunk_chain_q8`, then
    :func:`trunk_wgrad_q8`."""
    g_pe, gamax, g8s, col_ss = trunk_chain_q8(masks, g_h, q8, dtype, g, group_rows)
    trunk_wgrad_q8(pe, acts, g8s, col_ss, g, group_rows)
    return g_pe, gamax


def heads(h, emb64, w, dtype):
    """Per-sample heads from the trunk output h and the (M, 64) padded
    embedding: (sigma, albedo, ts, tb) and the residuals their backward
    reads."""
    sig_pre = mm(h, w.sigma_w, w.sigma_b)
    bott = mm(h, w.bott_w, w.bott_b).to(dtype)
    ah_pre = mm(bott, w.alb_w0, w.alb_b0)
    ah = torch.relu(ah_pre).to(dtype)
    albedo = torch.sigmoid(mm(ah, w.alb_w1, w.alb_b1))
    t_in = torch.cat([bott, emb64.to(dtype)], dim=-1)
    t, t_acts, t_masks = t_in, [], []
    for i in range(4):
        pre = mm(t, w.tr_w[i], w.tr_b[i])
        t = torch.relu(pre).to(dtype)
        t_acts.append(t)
        t_masks.append((pre > 0).to(dtype))
    ts = torch.sigmoid(mm(t, w.ts_w, w.ts_b))
    tb_pre = mm(t, w.tb_w, w.tb_b)
    res = dict(sig_pre=sig_pre, bott=bott, ah_pre=ah_pre, ah=ah, t_in=t_in,
               t_acts=t_acts, t_masks=t_masks, tb_pre=tb_pre, albedo=albedo, ts=ts)
    return softplus(sig_pre), albedo, ts, softplus(tb_pre), res


def heads_backward(h, res, d_sigma, d_val, w, dtype, g):
    """VJP of :func:`heads` for the cotangents of sigma (M, 1) and of the
    values ``d_val`` (M, >= 6: albedo in columns 1-3, t_s in 4, t_beta in
    5), at the JAX kernels' rounding points. Fills the head entries 16-35 of
    the float32 gradients ``g``; returns the trunk output's cotangent g_h
    (compute dtype) and the embedding's (M, 4) float32."""
    albedo, ts = res["albedo"], res["ts"]
    g_sig_pre = d_sigma * torch.sigmoid(res["sig_pre"])
    g_ts_pre = d_val[:, 4:5] * ts * (1.0 - ts)
    g_tb_pre = d_val[:, 5:6] * torch.sigmoid(res["tb_pre"])
    t_acts, t_masks = res["t_acts"], res["t_masks"]
    g[32], g[33] = outer(t_acts[3], g_ts_pre.to(dtype)), colsum(g_ts_pre)
    g[34], g[35] = outer(t_acts[3], g_tb_pre.to(dtype)), colsum(g_tb_pre)
    g_t = mm_t(g_ts_pre, w.ts_w, dtype) + mm_t(g_tb_pre, w.tb_w, dtype)
    for i in range(3, -1, -1):
        g_pre = g_t * t_masks[i]
        g[24 + i] = outer(res["t_in"] if i == 0 else t_acts[i - 1], g_pre)
        g[28 + i] = colsum(g_pre)
        g_t = mm_t(g_pre, w.tr_w[i], dtype)
    g_alb_pre = d_val[:, 1:4] * albedo * (1.0 - albedo)
    g[22], g[23] = outer(res["ah"], g_alb_pre.to(dtype)), colsum(g_alb_pre)
    g_ah = (res["ah_pre"] > 0).to(dtype) * mm_t(g_alb_pre, w.alb_w1, dtype)
    g[20], g[21] = outer(res["bott"], g_ah), colsum(g_ah)
    g_bott = g_t[:, :256] + mm_t(g_ah, w.alb_w0, dtype)
    g[18], g[19] = outer(h, g_bott), colsum(g_bott)
    g[16], g[17] = outer(h, g_sig_pre.to(dtype)), colsum(g_sig_pre)
    g_h = mm_t(g_bott, w.bott_w, dtype) + mm_t(g_sig_pre, w.sigma_w, dtype)
    return g_h, g_t[:, 256:260].float()


def sigma_backward(pe, acts, masks, sig_pre, d_sigma, w, dtype, trunk_grads=None):
    """VJP of the density trunk and sigma head for the sigma cotangent
    d_sigma (M, 1): the 36 float32 gradients (exact zeros past the density
    prefix) and the PE cotangent (compute dtype). ``trunk_grads(g_h, g)``
    replaces the trunk's backward (:func:`trunk_backward` by default)."""
    g_sig_pre = d_sigma * torch.sigmoid(sig_pre)
    g = [torch.zeros(x.shape, device=pe.device) for x in flatten_weights(w)]
    g[16], g[17] = outer(acts[-1], g_sig_pre.to(dtype)), colsum(g_sig_pre)
    g_h = mm_t(g_sig_pre, w.sigma_w, dtype)
    if trunk_grads is None:
        return g, trunk_backward(pe, acts, masks, g_h, w, dtype, g)
    return g, trunk_grads(g_h, g)


def pack_grads(flat):
    """36 float32 gradients in FieldWeights order, padded (in, out) matrices
    and (1, d) biases -> (mats, biases) in the packed kernel layout."""
    return (torch.cat([flat[i].t().reshape(-1) for i in _MAT_IDX]),
            torch.cat([flat[i].reshape(-1) for i in _BIAS_IDX]))


def emb_block(emb):
    """(N, 4) embeddings -> the (N, 64) zero-padded block the transient
    head's padded first matrix reads."""
    return F.pad(emb.float(), (0, PE_PAD - EMB_DIM))


# ---------------------------------------------------------------------------
# plain versions of the per-point kernels
# ---------------------------------------------------------------------------

def density_forward_reference(weights: KernelWeights, pos):
    """Plain PyTorch version of :func:`density_forward`: PE from the points
    themselves, the trunk and the sigma head."""
    dtype = weights.dtype
    w = kernel_views(weights)
    pe = pe_from_args(point_pe_args(pos), dtype)
    return softplus(mm(trunk(pe, w, dtype)[0][-1], w.sigma_w, w.sigma_b))[:, 0]


def density_backward_reference(weights: KernelWeights, pos, g):
    """Plain PyTorch version of :func:`density_backward`: the VJP of the
    density for the per-point cotangent ``g`` (N,), recomputing the
    forward, step by step as the JAX package's ``_density_bwd_kernel``.
    Returns (d_mats, d_biases) in the packed layout, float32, zero past the
    density prefix (the heads get exact zeros), and d_pos (N, 3)."""
    dtype = weights.dtype
    w = kernel_views(weights)
    xb = point_pe_args(pos)
    pe = pe_from_args(xb, dtype)
    acts, masks = trunk(pe, w, dtype)
    sig_pre = mm(acts[-1], w.sigma_w, w.sigma_b)
    grads, g_pe = sigma_backward(pe, acts, masks, sig_pre, g.float().reshape(-1, 1), w, dtype)
    return (*pack_grads(grads), point_grads(xb, g_pe, dtype))


def field_forward_reference(weights: KernelWeights, pos, emb):
    """Plain PyTorch version of :func:`field_forward`: PE from the points,
    the trunk and every per-sample head, float32 heads, the embedding in
    the 64-wide padded block."""
    dtype = weights.dtype
    w = kernel_views(weights)
    pe = pe_from_args(point_pe_args(pos), dtype)
    sigma, albedo, ts, tb, _ = heads(trunk(pe, w, dtype)[0][-1], emb_block(emb), w, dtype)
    zero = torch.zeros_like(sigma)
    return torch.cat([sigma, albedo, ts, tb, zero, zero], dim=1)


def field_backward_reference(weights: KernelWeights, pos, emb, g):
    """Plain PyTorch version of :func:`field_backward`: the VJP of the field
    for the per-point cotangent ``g`` (N, 8) in the forward's layout,
    recomputing the forward, step by step as the JAX package's
    ``_field_bwd_kernel``. Returns (d_mats, d_biases) in the packed layout,
    float32, d_pos (N, 3) and d_emb (N, 4)."""
    dtype = weights.dtype
    w = kernel_views(weights)
    xb = point_pe_args(pos)
    pe = pe_from_args(xb, dtype)
    acts, masks = trunk(pe, w, dtype)
    h = acts[-1]
    _, _, _, _, res = heads(h, emb_block(emb), w, dtype)
    g = g.float()
    grads = [None] * N_WEIGHTS
    g_h, d_emb = heads_backward(h, res, g[:, 0:1], g, w, dtype, grads)
    g_pe = trunk_backward(pe, acts, masks, g_h, w, dtype, grads)
    return (*pack_grads(grads), point_grads(xb, g_pe, dtype), d_emb)


# ---------------------------------------------------------------------------
# wrapper checks and the launch shared by every kernel
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


def launch(entry, what, device, *args, after_stream=()):
    """Call the library's C entry point ``entry`` on PyTorch's current stream
    of ``device``; tensors go by data pointer, ints as they are, then the
    stream, then ``after_stream``. Raises on a CUDA error."""
    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, entry)(*(a.data_ptr() if torch.is_tensor(a) else a for a in args),
                                   stream, *after_stream)
    _build.check(code, what)


def point_workspace(field, n, device):
    """The per-point backward kernels' scratch, sized by the library."""
    nbytes = _build.load_library().eonerf_point_bwd_workspace_bytes(int(field), n)
    return torch.empty((nbytes,), dtype=torch.uint8, device=device)


# ---------------------------------------------------------------------------
# the per-point kernels' wrappers
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
    launch("eonerf_density_fwd", "density_forward kernel launch", dev, pos, weights.mats,
           weights.biases, sigma, n)
    density_forward.launches += 1
    return sigma


density_forward.launches = 0


def density_backward(weights: KernelWeights, pos, g):
    """VJP of :func:`density_forward` for the per-point cotangent ``g``
    (N,): (d_mats, d_biases) float32 in the packed layout (zero past the
    density prefix) and d_pos (N, 3). CPU tensors: the plain version. CUDA
    tensors: the hand-written bf16 kernels (raises if they cannot run)."""
    if pos.device.type == "cpu":
        return density_backward_reference(weights, pos, g)
    n = pos.shape[0]
    dev = pos.device
    check_f32("pos", pos, (n, 3), dev)
    check_f32("g", g, (n,), dev)
    check_weights(weights, dev)
    d_mats = torch.zeros((MAT_ELEMENTS,), dtype=torch.float32, device=dev)
    d_biases = torch.zeros((BIAS_ELEMENTS,), dtype=torch.float32, device=dev)
    d_pos = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return d_mats, d_biases, d_pos
    launch("eonerf_density_bwd", "density_backward kernel launch", dev, pos, g, weights.mats,
           weights.biases, point_workspace(False, n, dev), d_mats, d_biases, d_pos, n)
    density_backward.launches += 1
    return d_mats, d_biases, d_pos


density_backward.launches = 0


def field_forward(weights: KernelWeights, pos, emb):
    """Per-point field (N, 8) = [sigma, albedo r g b, t_s, t_beta, 0, 0] for
    points (N, 3) and their embeddings (N, 4). CPU tensors: the plain
    version. CUDA tensors: the hand-written bf16 kernel (raises if it cannot
    be built or launched)."""
    if pos.device.type == "cpu":
        return field_forward_reference(weights, pos, emb)
    n = pos.shape[0]
    dev = pos.device
    check_f32("pos", pos, (n, 3), dev)
    check_f32("emb", emb, (n, EMB_DIM), dev)
    check_weights(weights, dev)
    out = torch.empty((n, FIELD_COLS), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    launch("eonerf_field_fwd", "field_forward kernel launch", dev, pos, emb, weights.mats,
           weights.biases, out, n)
    field_forward.launches += 1
    return out


field_forward.launches = 0


def field_backward(weights: KernelWeights, pos, emb, g):
    """VJP of :func:`field_forward` for the per-point cotangent ``g``
    (N, 8): (d_mats, d_biases) float32 in the packed layout, d_pos (N, 3)
    and d_emb (N, 4). CPU tensors: the plain version. CUDA tensors: the
    hand-written bf16 kernels (raises if they cannot be built or
    launched)."""
    if pos.device.type == "cpu":
        return field_backward_reference(weights, pos, emb, g)
    n = pos.shape[0]
    dev = pos.device
    check_f32("pos", pos, (n, 3), dev)
    check_f32("emb", emb, (n, EMB_DIM), dev)
    check_f32("g", g, (n, FIELD_COLS), dev)
    check_weights(weights, dev)
    d_mats = torch.zeros((MAT_ELEMENTS,), dtype=torch.float32, device=dev)
    d_biases = torch.zeros((BIAS_ELEMENTS,), dtype=torch.float32, device=dev)
    d_pos = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    d_emb = torch.zeros((n, EMB_DIM), dtype=torch.float32, device=dev)
    if n == 0:
        return d_mats, d_biases, d_pos, d_emb
    launch("eonerf_field_bwd", "field_backward kernel launch", dev, pos, emb, g, weights.mats,
           weights.biases, point_workspace(True, n, dev), d_mats, d_biases, d_pos, d_emb, n)
    field_backward.launches += 1
    return d_mats, d_biases, d_pos, d_emb


field_backward.launches = 0


# ---------------------------------------------------------------------------
# differentiable ops (the JAX package's custom_vjp pairs, recompute mode)
# ---------------------------------------------------------------------------

class _Field(torch.autograd.Function):
    """Forward saves only its inputs; the backward recomputes."""

    @staticmethod
    def forward(ctx, mats, biases, pos, emb, dtype):
        kw = KernelWeights(mats.to(dtype), biases)
        ctx.save_for_backward(kw.mats, biases, pos, emb)
        return field_forward(kw, pos, emb)

    @staticmethod
    def backward(ctx, g):
        mats, biases, pos, emb = ctx.saved_tensors
        d_mats, d_biases, d_pos, d_emb = field_backward(KernelWeights(mats, biases), pos, emb,
                                                        g.contiguous())
        return d_mats, d_biases, d_pos, d_emb, None


class _Density(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mats, biases, pos, dtype):
        kw = KernelWeights(mats.to(dtype), biases)
        ctx.save_for_backward(kw.mats, biases, pos)
        return density_forward(kw, pos)

    @staticmethod
    def backward(ctx, g):
        mats, biases, pos = ctx.saved_tensors
        d_mats, d_biases, d_pos = density_backward(KernelWeights(mats, biases), pos,
                                                   g.contiguous())
        return d_mats, d_biases, d_pos, None


def fused_field(weights: KernelWeights, pos, emb, compute_dtype):
    """Differentiable per-point field op over float32 packed weights (cast
    to ``compute_dtype`` inside, so their gradients arrive in float32):
    (sigma (N,), albedo (N, 3), t_s (N, 1), t_beta (N, 1)) for points (N, 3)
    and embeddings (N, 4); gradients flow to the weights, the points and
    the embeddings."""
    out = _Field.apply(weights.mats, weights.biases, pos.float().contiguous(),
                       emb.float().contiguous(), compute_dtype)
    return out[:, 0], out[:, 1:4], out[:, 4:5], out[:, 5:6]


def fused_density(weights: KernelWeights, pos, compute_dtype):
    """Differentiable per-point density op (N,), as :func:`fused_field`;
    gradients flow to the trunk and sigma-head weights and to the points."""
    return _Density.apply(weights.mats, weights.biases, pos.float().contiguous(), compute_dtype)
