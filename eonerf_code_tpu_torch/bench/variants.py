"""The kernel-variant bench's ops: stripped-down versions of the field kernel
that each remove one cost, and the compositing epilogues on the density
trunk, with their plain PyTorch versions beside them.

The counterparts of the research kernels that the JAX package times on the
TPU: the 20 bodies of scripts/bench_kernel_variants.py (``build`` and
``build_bwd``) and the 4 of scripts/proto_composite.py (``build``). Their
CUDA kernels are in csrc/kernel_variants.cu, apart from ``full`` (the field
kernel, ops/fused_field.py::field_forward) and ``trunk`` and ``base`` (the
density kernel, ``density_forward``), which those bodies are.

- :func:`run` / :func:`reference`: a variant of bench_kernel_variants.py on
  points ``pos`` (n, 3) in TPU grid tiles of ``tile`` rows; see
  :data:`VARIANTS`. Forward variants return out (n, 1) ((n, 8) for
  ``full``), ``mm_fwd_save`` (out, acts (n, 2048) bf16), the backward slabs
  (out, dW (8, 256, 256) float32, each (in, out)). ``trunk_gemm`` is no TPU
  body of its own: ``trunk``'s function on the design of the trunk
  variants and the compositing epilogues (trunk_variant_kernel on
  tile_common.cuh's gemm), the baseline each of them is read against
  (:data:`BASELINE_OF`), since ``trunk``, ``full`` and ``base`` run the
  production streamed forward.
- :func:`run_composite` / :func:`composite_reference`: a variant of
  proto_composite.py; :func:`composite_epilogue` is its epilogue alone, on a
  given sigma.
- :func:`check`: a variant's outputs against its plain version's (or the
  TPU body's) at the bench's gates; :func:`library_chain`: a slab chain as
  PyTorch library calls, a yardstick for timing only.

The slab chains (``mm_*``) read trunk matrix 1 only, in every layer, and
start each row from ``pos[first row of its block, 0]`` (blocks of ``tile``
rows, or ``tile / nsub`` for the split variants), as the TPU bodies do; an
optional ``h0`` (n, width) in the chain's type replaces that seed, so a test
can feed every row its own values.

Each wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches the hand-written kernel or raises, and counts its
launches in :data:`LAUNCHES` (one per call, whatever number of CUDA
launches the call makes: :data:`CUDA_LAUNCHES` says how many).
"""

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from eonerf_code_tpu_torch.ops import _build
from eonerf_code_tpu_torch.ops import fused_field as ff

BF16 = torch.bfloat16
W = 256                # trunk width
KPAD = 128             # samples a ray in the compositing prototypes
ACTS_COLS = 8 * W      # mm_fwd_save's activation stream
# H100 SXM dense peaks (NVIDIA's data sheet, at the 700 W power limit)
PEAK_BF16 = 989.4e12
PEAK_8BIT = 1978.9e12
PEAK_BYTES = 3.35e12

FORWARD = ("full", "trunk", "nope", "norelu", "nocast", "mm_only", "mm_int2", "mm_int4",
           "mm_i8", "mm_i8_dyn", "mm_f8", "mm_k512", "mm_i8_k512", "mm_merged2",
           "mm_merged4", "mm_seq2", "trunk_int2")
SLAB_BWD = ("mm_fwd_save", "mm_bwd_rec", "mm_bwd_saved")
BASELINES = ("trunk_gemm",)
VARIANTS = FORWARD + SLAB_BWD + BASELINES
DEFAULT_VARIANTS = ("full", "trunk", "nope", "norelu", "nocast", "mm_only")
COMPOSITES = ("base", "reshape", "colscan", "accmm")
INT8 = ("mm_i8", "mm_i8_dyn", "mm_i8_k512")

# bf16 chains: (schedule of kv_bf16_chain, depth, seed blocks a tile, width)
_BF16_CHAIN = {"mm_only": (0, 8, 1, W), "mm_merged2": (0, 16, 1, W),
               "mm_merged4": (0, 32, 1, W), "mm_int2": (1, 8, 2, W), "mm_int4": (2, 8, 4, W),
               "mm_seq2": (3, 8, 2, W), "mm_k512": (4, 4, 1, 2 * W),
               "mm_fwd_save": (5, 8, 1, W)}
# 8-bit chains: (fp8, width, depth)
_Q_CHAIN = {"mm_i8": (0, W, 8), "mm_i8_k512": (0, 2 * W, 4), "mm_f8": (1, W, 8)}
_TRUNK_MODE = {"nope": 0, "norelu": 1, "nocast": 2, "trunk_int2": 3, "trunk_gemm": 4}
_EPI = {"reshape": 0, "colscan": 1, "accmm": 2}
# the variant each one is read against, on the same design: one cost
# (the PE's sines, the ReLU, the casts, two chains, an epilogue, the heads)
# is their difference
BASELINE_OF = {**dict.fromkeys(("nope", "norelu", "nocast", "trunk_int2", "reshape", "colscan",
                                "accmm"), "trunk_gemm"), "full": "trunk"}
# the TPU body a variant computes (its own name but for the baseline)
TPU_BODY = {"trunk_gemm": "trunk"}

LAUNCHES = dict.fromkeys(VARIANTS + COMPOSITES, 0)
# CUDA launches one call of a variant makes on the card
CUDA_LAUNCHES = {**dict.fromkeys(VARIANTS + COMPOSITES, 1), "mm_i8": 2, "mm_i8_k512": 2,
                 "mm_f8": 2, "mm_i8_dyn": 10, "mm_bwd_rec": 4, "mm_bwd_saved": 3}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# work and bounds (the TPU script's own flops() formulas)
# ---------------------------------------------------------------------------

def flops(variant, n):
    """Operations of one call on n points (2 per multiply-add)."""
    trunk = 2 * (64 * 256 + 6 * 256 * 256 + 320 * 256)
    heads_full = 2 * (256 + 256 * 256 + 256 * 128 + 128 * 3
                      + 320 * 128 + 3 * 128 * 128 + 2 * 128)
    slab = 2 * 256 * 256
    per_pt = {"full": trunk + heads_full, "mm_merged2": 16 * slab, "mm_merged4": 32 * slab,
              "mm_k512": 2 * 4 * 512 * 512, "mm_i8_k512": 2 * 4 * 512 * 512,
              "mm_bwd_rec": 24 * slab, "mm_bwd_saved": 16 * slab}
    for v in ("trunk", "nope", "norelu", "nocast", "trunk_int2", "trunk_gemm") + COMPOSITES:
        per_pt[v] = trunk + 512
    for v in ("mm_only", "mm_seq2", "mm_int2", "mm_int4", "mm_i8", "mm_i8_dyn", "mm_f8",
              "mm_fwd_save"):
        per_pt[v] = 8 * slab
    return per_pt[variant] * n


def min_bytes(variant, n):
    """Bytes one call must move: each input read once, each output written
    once (the weights' few hundred KB left out)."""
    if variant in COMPOSITES:
        return n * 12 + n * 4 + (n // KPAD * 32 if variant == "accmm" else n * 4)
    nbytes = n * 12 + n * 4
    if variant == "full":
        nbytes += n * 16 + n * 28
    if variant in ("mm_fwd_save", "mm_bwd_saved"):
        nbytes += n * ACTS_COLS * 2
    if variant in ("mm_bwd_rec", "mm_bwd_saved"):
        nbytes += 8 * W * W * 4
    return nbytes


def peak(variant):
    """(peak operations per second, unit) of the variant's arithmetic."""
    if variant in INT8:
        return PEAK_8BIT, "TOP/s"
    if variant == "mm_f8":
        return PEAK_8BIT, "TFLOP/s"
    return PEAK_BF16, "TFLOP/s"


def bound_ms(variant, n):
    """(least time on an H100 SXM in ms, "operations" or "bytes")."""
    ops_ms = flops(variant, n) / peak(variant)[0] * 1e3
    bytes_ms = min_bytes(variant, n) / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

class SlabWeights(NamedTuple):
    """The slab chains' matrices, packed (out, in) bf16 as the kernels read
    them: ``w1`` trunk matrix 1 (256 x 256), ``wbig`` the K = 512 chain's
    [[w1, w1], [w1, w1]] * 0.25 (512 x 512)."""

    w1: torch.Tensor
    wbig: torch.Tensor


def slab_weights(kw: ff.KernelWeights):
    off = 64 * W   # trunk matrix 0 (64 x 256) comes first
    w1 = kw.mats[off:off + W * W].view(W, W).to(BF16)
    row = torch.cat([w1, w1], dim=1)
    wbig = (torch.cat([row, row], dim=0) * 0.25).to(BF16)
    return SlabWeights(w1.contiguous(), wbig.contiguous())


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _seeds(pos, seg, coord):
    rows = torch.arange(pos.shape[0], device=pos.device) // seg * seg
    return pos[rows, coord].float()


def _i8_trunc(x):
    """float -> int8 values as the TPU converts: toward zero, saturating."""
    return torch.trunc(x.clamp(-128.0, 127.0))


def f8_round(x):
    """float32 -> float8_e4m3fn values (float32) as ml_dtypes rounds: to
    nearest even, NaN above 464 (PyTorch's conversion saturates there)."""
    y = x.to(torch.float8_e4m3fn).float()
    return torch.where(x.abs() > 464.0, torch.full_like(y, math.nan), y)


def _i8_weights(w_in_out, kw):
    wf = w_in_out.float()
    if kw != W:
        wf = torch.cat([torch.cat([wf, wf], dim=1)] * 2, dim=0) * 0.25
    return _i8_trunc((wf * 127.0).clamp(-127.0, 127.0))


def _bf16_chain(h, w_in_out, depth, relu):
    layers = []
    for _ in range(depth):
        pre = h.float() @ w_in_out.float()
        h = (torch.relu(pre) if relu else pre).to(BF16)
        layers.append(h)
    return h, layers


def _h0_or_seed(h0, pos, seg, kw, convert):
    if h0 is not None:
        return h0
    return convert(_seeds(pos, seg, 0))[:, None].expand(pos.shape[0], kw)


def reference(variant, kw, sw, pos, emb=None, acts=None, tile=2048, h0=None):
    """Plain PyTorch version of :func:`run` (same arguments and results)."""
    n = pos.shape[0]
    if variant == "full":
        return ff.field_forward_reference(kw, pos, emb)
    if variant == "trunk" or variant in _TRUNK_MODE:
        return trunk_variant_reference(variant, kw, pos)
    w1 = sw.w1.t()   # (in, out)
    if variant in _BF16_CHAIN:
        _, depth, nsub, width = _BF16_CHAIN[variant]
        w = sw.wbig.t() if width != W else w1
        h = _h0_or_seed(h0, pos, tile // nsub, width, lambda s: s.to(BF16))
        h, layers = _bf16_chain(h, w, depth, relu=variant == "mm_fwd_save")
        out = h[:, :1].float()
        return (out, torch.cat(layers, dim=1)) if variant == "mm_fwd_save" else out
    if variant in ("mm_i8", "mm_i8_k512"):
        _, width, depth = _Q_CHAIN[variant]
        w8 = _i8_weights(w1, width)
        h = _h0_or_seed(None if h0 is None else h0.float(), pos, tile, width, _i8_trunc)
        for _ in range(depth):
            # the TPU body's (acc / 127^2) * 127 as XLA folds it: one rounding
            h = _i8_trunc(((h.float() @ w8) * (1.0 / 127.0)).clamp(-127.0, 127.0))
        return h[:, :1].float()
    if variant == "mm_f8":
        wq = f8_round(w1.float())
        h = _h0_or_seed(None if h0 is None else h0.float(), pos, tile, W, f8_round)
        for _ in range(8):
            h = f8_round(h.float() @ wq)
        return h[:, :1].float()
    if variant == "mm_i8_dyn":
        return i8_dyn_reference(w1, pos, tile, h0)[0]
    if variant in ("mm_bwd_rec", "mm_bwd_saved"):
        return slab_bwd_reference(w1, pos, tile, acts if variant == "mm_bwd_saved" else None, h0)
    raise ValueError(f"unknown variant {variant!r}")


def i8_dyn_reference(w1, pos, tile, h0=None):
    """mm_i8_dyn: (out (n, 1), the amax each layer quantized with (n / tile,
    8)). Each layer: s = max(amax of the tile's |hf|, 1e-12) / 127,
    h8 = round(hf / s) (half to even), hf = (h8 @ w8) * (s / 127)."""
    n = pos.shape[0]
    w8 = _i8_weights(w1, W)
    hf = _h0_or_seed(h0, pos, tile, W, lambda s: s).float()
    amaxes = []
    for _ in range(8):
        amax = hf.abs().reshape(n // tile, -1).amax(dim=1)
        amaxes.append(amax)
        s = (amax.clamp(min=1e-12) * (1.0 / 127.0)).repeat_interleave(tile)[:, None]
        h8 = torch.round(hf / s).clamp(-128.0, 127.0)
        hf = (h8 @ w8) * (s * (1.0 / 127.0))
    return hf[:, :1], torch.stack(amaxes, dim=1)


def slab_bwd_reference(w1, pos, tile, acts=None, h0=None):
    """mm_bwd_rec (acts None: the ReLU chain recomputed from h0) and
    mm_bwd_saved (acts (n, 2048) bf16): per layer i = 7..0,
    g *= (acts_i > 0), dW_i = inp_i^T g, g = round_bf16(g @ W^T), from
    g = pos[first row of the tile, 1]. Returns (g[:, :1], dW (8, 256, 256))."""
    n = pos.shape[0]
    h = _h0_or_seed(h0, pos, tile, W, lambda s: s.to(BF16))
    if acts is None:
        _, layers = _bf16_chain(h, w1, 8, relu=True)
    else:
        layers = [acts[:, W * i:W * (i + 1)] for i in range(8)]
    g = _seeds(pos, tile, 1).to(BF16)[:, None].expand(n, W)
    dws = [None] * 8
    for i in range(7, -1, -1):
        g = g * (layers[i].float() > 0).to(BF16)
        dws[i] = (layers[i - 1] if i > 0 else h).float().t() @ g.float()
        g = (g.float() @ w1.float().t()).to(BF16)
    return g[:, :1].float(), torch.stack(dws)


def trunk_variant_reference(variant, kw, pos):
    """trunk and trunk_gemm, nope (linear PE), norelu (no ReLU), nocast and
    trunk_int2 (the exact float32 sin/cos PE): sigma (n, 1)."""
    dtype = kw.dtype
    w = ff.kernel_views(kw)
    xb = ff.point_pe_args(pos)
    if variant in ("trunk", "trunk_gemm", "norelu"):
        pe = ff.pe_from_args(xb, dtype)
    elif variant == "nope":
        col = torch.arange(ff.PE_PAD, device=pos.device)
        pe = torch.where(col < ff.PE_DIM, xb, 0.0).to(dtype)
    else:
        pe = ff.pe_from_args(xb, torch.float32).to(dtype)
    if variant == "norelu":
        h = pe
        for i in range(8):
            inp = torch.cat([h, pe], dim=-1) if i == 5 else h
            h = ff.mm(inp, w.trunk_w[i], w.trunk_b[i]).to(dtype)
    else:
        h = ff.trunk(pe, w, dtype)[0][-1]
    return ff.softplus(ff.mm(h, w.sigma_w, w.sigma_b))


def composite_epilogue(variant, sigma, sd):
    """The compositing epilogue on sigma (n,): sdelta = sigma sd,
    T = exp(-exclusive cumsum of sdelta over each ray's KPAD samples, the
    TPU kernels' Hillis-Steele order), w = T (1 - exp(-sdelta)). reshape and
    colscan: w (n, 1); accmm: per ray sum_k w_k sigma_k in all 8 columns."""
    y = (sigma.float() * sd.reshape(-1).float()).reshape(-1, KPAD)
    z = F.pad(y[:, :-1], (1, 0))
    d = 1
    while d < KPAD:
        z = z + F.pad(z[:, :-d], (d, 0))
        d *= 2
    w = torch.exp(-z) * (1.0 - torch.exp(-y))
    if variant == "accmm":
        return (w * sigma.float().reshape(-1, KPAD)).sum(dim=1, keepdim=True).expand(-1, 8)
    return w.reshape(-1, 1)


def composite_reference(variant, kw, pos, sd, tile=KPAD * 16):
    """Plain PyTorch version of :func:`run_composite`."""
    _check_composite_tile(tile)
    sigma = ff.density_forward_reference(kw, pos)
    return sigma[:, None] if variant == "base" else composite_epilogue(variant, sigma, sd)


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

# bf16 outputs, streams and each dW, per tensor: the same rounding points on
# both sides and the f32 sums in another order; a sum within rounding of a
# bf16 boundary rounds the other way and travels down the chain
REL_L2 = 1e-2
# fp8 (3 mantissa bits): one rounding that flips moves a value by 1/8
F8_REL_L2 = 5e-2
# the port's forward gates (outputs of order 1), held also by full, trunk
# and the compositing prototypes
FWD_TOL = {"max_abs": 2e-2, "mean_abs": 2e-3}
FWD_GATED = ("full", "trunk") + COMPOSITES
# the compositing epilogue on the same sigma: the same f32 operations in the
# same order; exp rounds differently in two libraries
EPILOGUE_REL_L2 = 1e-5
# mm_bwd_rec against the all-plain backward, whose own recompute can put a
# ReLU mask on the other side of a kink in a few seeded tiles, each weighing
# as its 2048 identical rows: 2.97e-2 worst dW on NVIDIA H100 80GB HBM3,
# 700 W, at the bench's default n (REL_L2 against the plain backward on the
# kernel's own recomputed activations)
REC_ALL_PLAIN_REL_L2 = 5e-2


def rel_l2(a, b):
    """|a - b| / |b| in float64 (|a - b| where b is 0)."""
    a, b = a.double(), b.double()
    den, diff = float(b.norm()), float((a - b).norm())
    return diff / den if den > 0 else diff


def check(variant, got, ref, block=1 << 17):
    """``got``, a variant's outputs (a tensor or a tuple, as :func:`run` and
    :func:`run_composite` return them), against ``ref``, its plain
    version's or the TPU body's (any float type): {"ok", "max_abs_err",
    "rel_l2" (the worst tensor), ...}.

    NaN and infinities must stand where ref's do (e4m3 overflows to NaN);
    the finite values are held at REL_L2 (F8_REL_L2 for mm_f8), the eight
    dW of a backward slab one by one; the int8 chains record "equal", which
    mm_i8 and mm_i8_k512 must be (exact integer products, the same
    roundings; mm_i8_dyn is held at REL_L2, as an f32 product's order can
    move a group's amax); FWD_GATED also at FWD_TOL. mm_fwd_save's out is
    h7[:, 0] of a ReLU chain, zero on most tiles at the default n (norm
    1e-4, so its rel-L2, recorded as "out_rel_l2", says nothing): on both
    sides it must equal its own stream column, and the stream is held at
    the gate. Compared in blocks of ``block`` rows: the activation stream
    is 4 GB of bf16 at the default n."""
    got = list(got) if isinstance(got, (tuple, list)) else [got]
    ref = list(ref) if isinstance(ref, (tuple, list)) else [ref]
    res = {"ok": len(got) == len(ref), "max_abs_err": 0.0, "rel_l2": 0.0}
    if variant == "mm_fwd_save":
        res["out_rel_l2"] = rel_l2(got[0], ref[0])
        res["out_is_stream_h7_col0"] = all(
            bool(torch.equal(out[:, 0].float(), stream[:, 7 * W].float()))
            for out, stream in (got, ref))
        res["ok"] &= res["out_is_stream_h7_col0"]
        got, ref = got[1:], ref[1:]
    sum_abs, count = 0.0, 0
    for g, r in zip(got, ref):
        res["ok"] &= tuple(g.shape) == tuple(r.shape)
        for gp, rp in (list(zip(g, r)) if g.dim() == 3 else [(g, r)]):
            ss_d = ss_r = 0.0
            for i in range(0, gp.shape[0], block):
                gc, rc = gp[i:i + block].float(), rp[i:i + block].float()
                finite = torch.isfinite(rc)
                res["ok"] &= (bool(torch.equal(torch.isnan(gc), torch.isnan(rc)))
                              and bool(torch.equal(torch.isfinite(gc), finite)))
                d = (gc - rc)[finite].abs().double()
                if d.numel():
                    res["max_abs_err"] = max(res["max_abs_err"], float(d.max()))
                ss_d += float(d.square().sum())
                ss_r += float(rc[finite].double().square().sum())
                sum_abs, count = sum_abs + float(d.sum()), count + gc.numel()
                if variant in INT8:
                    res["equal"] = res.get("equal", True) and bool(torch.equal(gc, rc))
            res["rel_l2"] = max(res["rel_l2"],
                                math.sqrt(ss_d / ss_r) if ss_r > 0 else math.sqrt(ss_d))
    if variant in FWD_GATED:
        res["mean_abs_err"] = sum_abs / count
        res["ok"] &= (res["max_abs_err"] <= FWD_TOL["max_abs"]
                      and res["mean_abs_err"] <= FWD_TOL["mean_abs"])
    if variant in ("mm_i8", "mm_i8_k512"):
        res["ok"] &= res["equal"]
    else:
        res["ok"] &= res["rel_l2"] <= (F8_REL_L2 if variant == "mm_f8" else REL_L2)
    return res


# ---------------------------------------------------------------------------
# library yardsticks
# ---------------------------------------------------------------------------

def library_chain(variant, sw, pos, acts=None, tile=2048):
    """The slab chain ``variant`` as PyTorch library calls on the same rows
    and seeds: cuBLAS through ``torch.matmul`` in bf16, ``torch._int_mm``
    with the requantization in eager ops, ``torch._scaled_mm`` in e4m3. A
    callable to time, which the port never calls; for the other variants,
    or where the installed PyTorch lacks the call, a string saying why
    there is none."""
    if not variant.startswith("mm_"):
        return "none: no one library call computes the function"
    w = sw.w1.t()   # (in, out)
    if variant in SLAB_BWD:
        return _library_slab(variant, w, pos, acts, tile)
    if variant in _BF16_CHAIN:
        _, depth, nsub, width = _BF16_CHAIN[variant]
        wk = sw.wbig.t() if width != W else w
        h0 = _h0_or_seed(None, pos, tile // nsub, width, lambda s: s.to(BF16)).contiguous()

        def chain():
            h = h0
            for _ in range(depth):
                h = torch.matmul(h, wk)
            return h
        return chain
    if variant == "mm_f8":
        return _library_f8(w, pos, tile)
    return _library_int8(variant, w, pos, tile)


def _library_slab_inputs(w, pos, tile):
    n = pos.shape[0]
    h0 = _h0_or_seed(None, pos, tile, W, lambda s: s.to(BF16)).contiguous()
    g0 = _seeds(pos, tile, 1).to(BF16)[:, None].expand(n, W).contiguous()
    try:    # bf16 operands, float32 out, as the kernels' dW
        torch.mm(h0[:8].t(), g0[:8], out_dtype=torch.float32)
        out_f32 = {"out_dtype": torch.float32}
    except (TypeError, RuntimeError, NotImplementedError):
        out_f32 = {}                # this PyTorch has none: bf16 out

    def dgrad(layers):
        """The cotangent chain g *= (acts_i > 0), g = g @ W^T for i = 7..0:
        (the last g, the masked cotangents g_0..g_7)."""
        g, cots = g0, [None] * 8
        for i in range(7, -1, -1):
            g = g * (layers[i] > 0)
            cots[i] = g
            g = torch.matmul(g, w.t())
        return g, cots

    def wgrad(layers, cots):
        """The 8 weight-gradient products inp_i^T g_i."""
        return [torch.mm((layers[i - 1] if i else h0).t(), cots[i], **out_f32) for i in range(8)]
    return h0, dgrad, wgrad


def _library_slab(variant, w, pos, acts, tile):
    h0, dgrad, wgrad = _library_slab_inputs(w, pos, tile)
    stream = torch.empty((pos.shape[0], ACTS_COLS), dtype=BF16, device=pos.device)

    def forward():
        h, layers = h0, []
        for i in range(8):
            h = torch.matmul(h, w).relu_()
            stream[:, W * i:W * (i + 1)].copy_(h)
            layers.append(h)
        return layers

    def backward(layers):
        g, cots = dgrad(layers)
        wgrad(layers, cots)
        return g
    if variant == "mm_fwd_save":
        return forward
    if variant == "mm_bwd_rec":
        return lambda: backward(forward())
    saved = [acts[:, W * i:W * (i + 1)] for i in range(8)]
    return lambda: backward(saved)


def library_slab_passes(sw, pos, acts, tile=2048):
    """mm_bwd_saved's two products as separate library chains on the same
    rows and seeds, the yardsticks of :func:`slab_pass_ms`: (dgrad, wgrad).
    ``dgrad()``: the masked cotangent chain through ``torch.matmul``,
    (g (n, 256) after layer 0, the masked cotangents g_0..g_7). ``wgrad()``:
    the 8 products inp_i^T g_i through ``torch.mm`` (float32 out where this
    PyTorch has it), on the cotangents of one dgrad() run made here. For
    timing; the port never calls them."""
    w = sw.w1.t()
    _, dgrad, wgrad = _library_slab_inputs(w, pos, tile)
    layers = [acts[:, W * i:W * (i + 1)] for i in range(8)]
    cots = dgrad(layers)[1]
    return (lambda: dgrad(layers)), (lambda: wgrad(layers, cots))


def slab_pass_bounds(n):
    """mm_bwd_saved's three launches on n rows: {pass: (least ms on an H100
    SXM, "operations" | "bytes"), "slab_wgrad_bytes": bytes}. Operations:
    the 8 products at the bf16 peak (dgrad and wgrad). Bytes at 3.35 TB/s,
    each input read once and each output written once: slab_dgrad reads
    the 8 layers' ReLU masks (h0..h7) and the seeds and writes the 8 masked
    cotangents and out; slab_wgrad reads h0..h6 (layer 0's input, the seed,
    from pos) and the 8 cotangents and writes the per-split partials; the
    reduction reads those and writes dW."""
    splits = max(1, min(16, n // 1024))
    mats = 8 * W * W * 4
    ops_ms = 2.0 * 8 * W * W * n / PEAK_BF16 * 1e3
    nbytes = {"slab_dgrad": n * 12 + 2 * n * ACTS_COLS * 2 + n * 4 + W * W * 2,
              "slab_wgrad": n * 12 + n * (7 * W + ACTS_COLS) * 2 + splits * mats,
              "reduce": (splits + 1) * mats}
    out = {}
    for name, b in nbytes.items():
        o = ops_ms if name != "reduce" else 0.0
        bm = b / PEAK_BYTES * 1e3
        out[name] = (o, "operations") if o >= bm else (bm, "bytes")
    out["slab_wgrad_bytes"] = nbytes["slab_wgrad"]
    return out


def slab_pass_ms(sw, pos, acts, tile=2048, iters=10):
    """mm_bwd_saved's three CUDA launches timed one by one on the card, as
    the variant runs them on its workspace (CUDA events over ``iters``
    launches after a warm-up): {"slab_dgrad", "slab_wgrad", "reduce": ms}.
    Measurement launches: not counted in :data:`LAUNCHES`."""
    n, dev = pos.shape[0], pos.device
    if dev.type != "cuda":
        raise RuntimeError("slab_pass_ms times the kernels: CUDA tensors only")
    _check("acts", acts, (n, ACTS_COLS), BF16, dev)
    lib = _build.load_variants_library()
    ws = torch.empty((lib.kv_slab_bwd_workspace_bytes(1, n),), dtype=torch.uint8, device=dev)
    out = torch.empty((n, 1), dtype=torch.float32, device=dev)
    dw = torch.empty((8, W, W), dtype=torch.float32, device=dev)
    times = {}
    for p, name in enumerate(("slab_dgrad", "slab_wgrad", "reduce")):
        def launch(p=p, name=name):
            _launch("kv_slab_bwd_pass", f"mm_bwd_saved {name} launch", dev, p, pos, None, acts,
                    sw.w1, ws, out, dw, n, tile)
        launch()        # warm-up; fills what the next pass reads
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            launch()
        end.record()
        torch.cuda.synchronize(dev)
        times[name] = start.elapsed_time(end) / iters
    return times


def _library_int8(variant, w, pos, tile):
    if not hasattr(torch, "_int_mm"):
        return "none: this PyTorch has no torch._int_mm"
    n, dyn = pos.shape[0], variant == "mm_i8_dyn"
    _, width, depth = _Q_CHAIN.get(variant, (0, W, 8))
    w8 = _i8_weights(w, width).to(torch.int8).t().contiguous().t()   # column-major

    def requant(hf):
        if dyn:
            s = hf.abs().reshape(n // tile, -1).amax(1).clamp(min=1e-12) / 127.0
            return torch.round(hf / s.repeat_interleave(tile)[:, None]).to(torch.int8)
        return (hf * (1.0 / 127.0)).clamp(-127, 127).to(torch.int8)
    seeds = _seeds(pos, tile, 0)[:, None]
    h8_0 = (requant(seeds) if dyn else _i8_trunc(seeds).to(torch.int8)).expand(n, width)
    h8_0 = h8_0.contiguous()

    def int_chain():
        h8 = h8_0
        for _ in range(depth):
            h8 = requant(torch._int_mm(h8, w8).float())
        return h8
    try:
        int_chain()
    except RuntimeError as e:
        return f"none: torch._int_mm failed ({str(e).splitlines()[0][:120]})"
    return int_chain


def _library_f8(w, pos, tile):
    if not hasattr(torch, "_scaled_mm"):
        return "none: this PyTorch has no torch._scaled_mm"
    wq = w.float().to(torch.float8_e4m3fn).t().contiguous().t()   # column-major
    h_0 = _seeds(pos, tile, 0)[:, None].expand(pos.shape[0], W).to(torch.float8_e4m3fn)
    one = torch.ones((), device=pos.device)

    def f8_chain():
        h = h_0
        for _ in range(8):
            out = torch._scaled_mm(h, wq, scale_a=one, scale_b=one, out_dtype=torch.float32)
            h = (out[0] if isinstance(out, tuple) else out).to(torch.float8_e4m3fn)
        return h
    try:
        f8_chain()
    except (RuntimeError, TypeError) as e:
        return f"none: torch._scaled_mm failed ({str(e).splitlines()[0][:120]})"
    return f8_chain


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _launch(entry, what, device, *args):
    lib = _build.load_variants_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, entry)(*(a.data_ptr() if torch.is_tensor(a) else a for a in args),
                                   stream)
    _build.check(code, what, lib.kv_error_string)


def _check(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _h0_dtype(variant):
    if variant in ("mm_i8", "mm_i8_k512"):
        return torch.int8
    if variant == "mm_f8":
        return torch.float8_e4m3fn
    return torch.float32 if variant == "mm_i8_dyn" else BF16


def _check_composite_tile(tile):
    if tile != KPAD * 16:
        raise ValueError(f"the compositing prototypes take 16 rays of {KPAD} samples a tile "
                         f"(tile {KPAD * 16}), got {tile}")


def run(variant, kw, sw, pos, emb=None, acts=None, tile=2048, h0=None):
    """One call of ``variant`` on points ``pos`` (n, 3) float32 (``emb``
    (n, 4) for ``full``; ``acts`` (n, 2048) bf16 for ``mm_bwd_saved``).
    CPU tensors: the plain version. CUDA tensors: the hand-written kernel
    (raises if it cannot be built or launched)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if pos.device.type == "cpu":
        return reference(variant, kw, sw, pos, emb, acts, tile, h0)
    n, dev = pos.shape[0], pos.device
    _check("pos", pos, (n, 3), torch.float32, dev)
    nsub = _BF16_CHAIN.get(variant, (0, 0, 1, 0))[2]
    if tile <= 0 or tile % nsub or (variant == "mm_i8_dyn" and n % tile):
        raise ValueError(f"{variant}: tile {tile} does not split the {n} rows as it needs")
    seg = tile // nsub
    if variant in ("full", "trunk"):
        out = ff.field_forward(kw, pos, emb) if variant == "full" else ff.density_forward(kw, pos)
        LAUNCHES[variant] += 1
        return out if variant == "full" else out[:, None]
    if variant in _TRUNK_MODE:
        ff.check_weights(kw, dev)
        out = torch.empty((n, 1), dtype=torch.float32, device=dev)
        _launch("kv_trunk_variant", f"{variant} kernel launch", dev, _TRUNK_MODE[variant], pos,
                kw.mats, kw.biases, out, n)
        LAUNCHES[variant] += 1
        return out
    for name, m in (("w1", sw.w1), ("wbig", sw.wbig)):
        _check(name, m, (m.shape[0], m.shape[0]), BF16, dev)
    width = _BF16_CHAIN[variant][3] if variant in _BF16_CHAIN else _Q_CHAIN.get(variant,
                                                                                (0, W))[1]
    if h0 is not None:
        _check("h0", h0, (n, width), _h0_dtype(variant), dev)
    out = torch.empty((n, 1), dtype=torch.float32, device=dev)
    if variant in _BF16_CHAIN:
        schedule, depth, _, _ = _BF16_CHAIN[variant]
        save = variant == "mm_fwd_save"
        stream = torch.empty((n, ACTS_COLS), dtype=BF16, device=dev) if save else None
        _launch("kv_bf16_chain", f"{variant} kernel launch", dev, schedule, pos, h0,
                sw.wbig if width != W else sw.w1, depth, out, stream, n, seg)
        LAUNCHES[variant] += 1
        return (out, stream) if save else out
    if variant in _Q_CHAIN:
        fp8, _, depth = _Q_CHAIN[variant]
        w8 = torch.empty((width * width,), dtype=torch.uint8, device=dev)
        _launch("kv_q_chain", f"{variant} kernel launch", dev, fp8, width, pos,
                None if h0 is None else h0.view(torch.uint8), sw.w1, w8, depth, out, n, seg)
        LAUNCHES[variant] += 1
        return out
    if variant == "mm_i8_dyn":
        return i8_dyn(sw, pos, tile, h0)[0]
    # the backward slabs
    saved = variant == "mm_bwd_saved"
    if saved:
        _check("acts", acts, (n, ACTS_COLS), BF16, dev)
    lib = _build.load_variants_library()
    ws = torch.empty((lib.kv_slab_bwd_workspace_bytes(int(saved), n),), dtype=torch.uint8,
                     device=dev)
    dw = torch.empty((8, W, W), dtype=torch.float32, device=dev)
    _launch("kv_slab_bwd", f"{variant} kernel launch", dev, pos, h0, acts if saved else None,
            sw.w1, ws, out, dw, n, seg)
    LAUNCHES[variant] += 1
    return out, dw


def i8_dyn(sw, pos, tile, h0=None):
    """mm_i8_dyn on the card: (out (n, 1), the amax each layer quantized with
    (n / tile, 8)); CPU tensors: :func:`i8_dyn_reference`."""
    if pos.device.type == "cpu":
        return i8_dyn_reference(sw.w1.t(), pos, tile, h0)
    n, dev = pos.shape[0], pos.device
    _check("pos", pos, (n, 3), torch.float32, dev)
    if tile <= 0 or n % tile:
        raise ValueError(f"mm_i8_dyn: {n} rows are not whole tiles of {tile}")
    if h0 is not None:
        _check("h0", h0, (n, W), torch.float32, dev)
    lib = _build.load_variants_library()
    ws = torch.empty((lib.kv_dyn_workspace_bytes(n),), dtype=torch.uint8, device=dev)
    amax = torch.zeros((n // tile, 8), dtype=torch.float32, device=dev)
    out = torch.empty((n, 1), dtype=torch.float32, device=dev)
    _launch("kv_i8_dyn", "mm_i8_dyn kernel launch", dev, pos, h0, sw.w1, ws, amax, out, n, tile,
            tile)
    LAUNCHES["mm_i8_dyn"] += 1
    return out, amax


def run_composite(variant, kw, pos, sd, tile=KPAD * 16):
    """One call of the compositing prototype ``variant`` on points ``pos``
    (n, 3), n a multiple of 128 (rays of KPAD samples, one after the other),
    with the per-sample ``sd`` (n / 128, 128) or (n, 1) float32. base: sigma
    (n, 1); reshape, colscan: w (n, 1); accmm: (n / 128, 8). CPU tensors: the
    plain version; CUDA tensors: the kernel (raises if it cannot run)."""
    if variant not in COMPOSITES:
        raise ValueError(f"unknown compositing variant {variant!r}")
    if pos.device.type == "cpu":
        return composite_reference(variant, kw, pos, sd, tile)
    _check_composite_tile(tile)
    n, dev = pos.shape[0], pos.device
    _check("pos", pos, (n, 3), torch.float32, dev)
    if n % KPAD:
        raise ValueError(f"{n} points are not whole rays of {KPAD} samples")
    if variant == "base":
        out = ff.density_forward(kw, pos)[:, None]
        LAUNCHES[variant] += 1
        return out
    if sd.numel() != n or sd.dtype != torch.float32 or not sd.is_contiguous() or sd.device != dev:
        raise ValueError(f"sd must be {n} contiguous float32 values on {dev}")
    ff.check_weights(kw, dev)
    shape = (n // KPAD, 8) if variant == "accmm" else (n, 1)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    _launch("kv_composite", f"{variant} kernel launch", dev, _EPI[variant], pos, sd, kw.mats,
            kw.biases, out, n)
    LAUNCHES[variant] += 1
    return out
