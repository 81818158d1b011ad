"""The production backwards launch by launch, and their weight-gradient pass
beside a library yardstick.

Each bf16 backward of ops/fused_render.py and ops/fused_field.py runs four
CUDA launches over one workspace (csrc/fused_render.cu): the first pass (the
recompute, or the heads from the saved stream), dgrad, wgrad and the
fixed-order reduction. The first two leave an activation stream and a
cotangent stream, one bf16 row a sample, and wgrad forms every weight
gradient as A^T G over their rows, A and G column slices of the two
(:func:`wgrad_jobs`).

- :func:`backward_pass_ms`: the saved camera or shadow backward's four
  launches timed one by one (C entry ``eonerf_bwd_pass``), beside
  :func:`wgrad_library` on the workspace's own streams and each launch's
  bound;
- :func:`wgrad_library`: the wgrad pass's products as ``torch.mm`` calls on
  the same stream slices, a yardstick for timing that the port never calls;
- :func:`dgrad_library`: the dgrad pass's cotangent chain as PyTorch calls
  on the same streams (``torch.mm`` of g @ W^T a layer, rounded to bf16,
  the ReLU mask from the activation stream, the column sums), a yardstick
  for timing that the port never calls;
- :func:`dgrad_phases`: where the dgrad kernel's time goes, the clock
  cycles a tile spends in each of its phases (:data:`PHASES`), from an
  instrumented copy of csrc/ built under _build/ (git-ignored);
- :func:`workspace_streams`, :func:`wgrad_operands`, :func:`pack_wgrad`,
  :func:`wgrad_alone` (C entry ``eonerf_wgrad``): the streams a backward
  left in its workspace, and the pass alone on given streams, for tests.

On the card, the saved backwards at a training batch (1024 rays, camera
K=127, shadow K=63), and the dgrad phases of this tree's csrc/ or of
another tree's (a parent commit's csrc/, unpacked with `git archive`):

    python -m eonerf_code_tpu_torch.bench.backward_passes [iters]
    python -m eonerf_code_tpu_torch.bench.backward_passes phases [OTHER/fused_render.cu]
    python -m eonerf_code_tpu_torch.bench.backward_passes attribution
"""

import concurrent.futures
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from eonerf_code_tpu_torch.bench.kernel_variants import bench_weights, resolve_device
from eonerf_code_tpu_torch.ops import _build
from eonerf_code_tpu_torch.ops import fused_field as ff
from eonerf_code_tpu_torch.ops import fused_render as fr

BF16 = torch.bfloat16
PEAK_BF16 = 989.4e12   # H100 SXM dense peaks (NVIDIA's data sheet, 700 W)
PEAK_BYTES = 3.35e12
PASSES = ("first", "dgrad", "wgrad", "reduce")
HG = 8                 # f32 head cotangents a sample, between the first pass and dgrad

# stream columns (csrc/fused_render.cu): activations h0..h4 | PE | h5..h7 |
# bottleneck | embedding block | albedo hidden | t0..t3; cotangents of the
# trunk's pre-activations | bottleneck | albedo hidden | t0..t3 | sigma,
# albedo, t_s, t_beta 8 columns each (the shadow's: trunk | sigma)
_A_PE, _A_BOTT, _A_AH, _A_T0 = 1280, 2112, 2432, 2560
_G_BOTT, _G_AH, _G_TR0 = 2048, 2304, 2432
_G_SIG, _G_ALB1, _G_TS, _G_TB = 2944, 2952, 2960, 2968
STREAM_COLS = {True: (3072, 2976), False: (2112, 2056)}   # (activation, cotangent)


def wgrad_jobs(camera):
    """(in, out, activation column, cotangent column) of each weight-gradient
    product of a camera (18) or shadow (9) backward, in the packed order
    (mat_job of csrc/fused_render.cu)."""
    h = [fr._act_col(i) for i in range(8)]
    jobs = [(64, 256, _A_PE, 0)] + [(320 if i == 5 else 256, 256, h[4] if i == 5 else h[i - 1],
                                     256 * i) for i in range(1, 8)]
    if not camera:
        return jobs + [(256, 1, h[7], 8 * 256)]
    return jobs + [(256, 1, h[7], _G_SIG), (256, 256, h[7], _G_BOTT), (256, 128, _A_BOTT, _G_AH),
                   (128, 3, _A_AH, _G_ALB1), (320, 128, _A_BOTT, _G_TR0)] + [
        (128, 128, _A_T0 + 128 * i, _G_TR0 + 128 * (i + 1)) for i in range(3)] + [
        (128, 1, _A_T0 + 384, _G_TS), (128, 1, _A_T0 + 384, _G_TB)]


def wgrad_operands(camera, acts, gpre):
    """[(A_i, G_i)]: each product's column slices (views) of the activation
    stream ``acts`` and the cotangent stream ``gpre``."""
    return [(acts[:, a:a + i], gpre[:, b:b + o]) for i, o, a, b in wgrad_jobs(camera)]


def pack_wgrad(products):
    """Weight gradients (in, out) in the packed order -> the packed (out,
    in) matrix buffer (MAT_ELEMENTS), zero past them."""
    flat = torch.cat([p.t().reshape(-1) for p in products])
    return F.pad(flat, (0, ff.MAT_ELEMENTS - flat.numel()))


def _f32_out(a, b):
    """torch.mm keywords for bf16 operands with a float32 result where this
    PyTorch has them, else None."""
    try:
        torch.mm(a[:8].t(), b[:8], out_dtype=torch.float32)
        return {"out_dtype": torch.float32}
    except (TypeError, RuntimeError, NotImplementedError):
        return None


def wgrad_library(camera, acts, gpre):
    """The wgrad pass as library calls: a callable forming the 18 (camera)
    or 9 (shadow) products A_i^T G_i with ``torch.mm`` on the streams'
    column slices, bf16 operands and a float32 result (where this PyTorch
    has no such call, the operands in float32). Returns the products (in,
    out). A yardstick for timing; the port never calls it."""
    ops = wgrad_operands(camera, acts, gpre)
    kw = _f32_out(*ops[0])
    if kw is None:
        return lambda: [a.float().t() @ g.float() for a, g in ops]
    return lambda: [torch.mm(a.t(), g, **kw) for a, g in ops]



def _packed_mats(mats):
    """(out, in) views of the packed matrices, in the packed order."""
    views, off = [], 0
    for n_in, n_out in ff._MAT_SHAPES:
        views.append(mats[off:off + n_in * n_out].view(n_out, n_in))
        off += n_in * n_out
    return views


def dgrad_library(camera, mats, acts, gpre):
    """The dgrad pass as library calls: a callable running the cotangent
    chain of a camera or shadow backward on the streams a backward left
    (``acts``, ``gpre``) and the packed bf16 matrices ``mats``: from the
    head cotangents in ``gpre``'s head columns, each layer's g @ W^T as one
    bf16 ``torch.mm`` (rounded at its output), the ReLU mask from ``acts``
    applied into ``gpre``'s columns of that layer (the kernel's stores) and
    the f32 column sums (the bias gradients); the PE cotangent and, for the
    camera, the embedding's at the end. Returns (column sums, g_pe, g_emb
    or None). A yardstick for timing that the port never calls; it
    overwrites ``gpre``'s layer columns with what they already hold."""
    w = _packed_mats(mats)
    h = [fr._act_col(i) for i in range(8)]

    def masked(g, a_col, g_col):
        out = gpre[:, g_col:g_col + g.shape[1]]
        torch.mul(g, acts[:, a_col:a_col + g.shape[1]] > 0, out=out)
        return out, out.sum(0, dtype=torch.float32)

    def run():
        sums, g_emb = [], None
        if camera:
            g_sig, g_alb = gpre[:, _G_SIG:_G_SIG + 1], gpre[:, _G_ALB1:_G_ALB1 + 3]
            g = gpre[:, _G_TS:_G_TS + 1] * w[16] + gpre[:, _G_TB:_G_TB + 1] * w[17]
            g, s = masked(g, _A_T0 + 384, _G_TR0 + 384)
            sums.append(s)
            for i in (15, 14, 13):    # transient layers 3, 2, 1 -> t2, t1, t0
                g, s = masked(torch.mm(g, w[i]), _A_T0 + 128 * (i - 13), _G_TR0 + 128 * (i - 13))
                sums.append(s)
            x = torch.mm(g, w[12])    # [g_bott | g_emb]
            g_emb = x[:, 256:260]
            g_ah, s = masked(torch.mm(g_alb, w[11]), _A_AH, _G_AH)
            sums.append(s)
            g = torch.add(x[:, :256], torch.mm(g_ah, w[10]), out=gpre[:, _G_BOTT:_G_BOTT + 256])
            sums.append(g.sum(0, dtype=torch.float32))
            g = torch.mm(g, w[9]) + g_sig * w[8]
        else:
            g = gpre[:, 2048:2049] * w[8]
        g, s = masked(g, h[7], 7 * 256)
        sums.append(s)
        pe = None
        for i in range(7, 0, -1):
            y = torch.mm(g, w[i])
            if i == 5:
                y, pe = y[:, :256], y[:, 256:]
            g, s = masked(y, h[i - 1], (i - 1) * 256)
            sums.append(s)
        return sums, torch.mm(g, w[0]) + pe, g_emb
    return run


# Where the dgrad kernel's time goes: an instrumented copy of csrc/ in which
# thread 0 of each block reads clock64() at the kernel's landmarks
# (DG_MARK(phase) starts a phase and ends the one before; the copy defines
# DG_MARK and its helpers, which the production source leaves empty or
# lacks), adds the cycles of each phase up over the block's tiles and
# writes the totals over the first entries of its row of bias partial sums
# (so the copy's bias gradients are wrong by design: they come back as the
# phases' sums over the blocks). prologue_c / products_c are the c-th
# product of a tile's chain (the ring's first chunk landing, then the rest
# of the call); epilogue the work after a product's last chunk.
CHAIN_CALLS = {True: ("tr3", "tr2", "tr1", "tr0", "alb0", "bott", "t7", "t6", "t5", "t4", "t3",
                      "t2", "t1", "t0"),
               False: ("t7", "t6", "t5", "t4", "t3", "t2", "t1", "t0")}
PHASES = ("heads_in", "head_loops", "mask_reads", "stores", "colsums", "pe_bwd", "ray_sums",
          "other", "epilogue", "barrier") + tuple(f"prologue_{c}" for c in range(14)) + tuple(
              f"products_{c}" for c in range(14))
_NPH = len(PHASES)
_PRO0, _MM0 = PHASES.index("prologue_0"), PHASES.index("products_0")
PHASE_PRELUDE = f"""// phase instrumentation (bench/backward_passes.py; this copy only)
#define DG_NPH {_NPH}
__shared__ long long dg_ph[DG_NPH + 3];   // phases, last clock, current phase, chain call
#define DG_MARK(next) do {{ if (threadIdx.x == 0) {{ const long long t_ = clock64(); \\
    dg_ph[dg_ph[DG_NPH + 1]] += t_ - dg_ph[DG_NPH]; dg_ph[DG_NPH] = t_; \\
    dg_ph[DG_NPH + 1] = (next); }} }} while (0)
#define DG_BEGIN() do {{ if (threadIdx.x == 0) {{ for (int k_ = 0; k_ < DG_NPH; ++k_) \\
    dg_ph[k_] = 0; dg_ph[DG_NPH] = clock64(); dg_ph[DG_NPH + 1] = {PHASES.index("other")}; \\
    dg_ph[DG_NPH + 2] = 0; }} }} while (0)
#define DG_TILE() do {{ DG_MARK(0); if (threadIdx.x == 0) dg_ph[DG_NPH + 2] = 0; }} while (0)
#define DG_PRO() DG_MARK({_PRO0} + dg_ph[DG_NPH + 2])
#define DG_MM() DG_MARK({_MM0} + dg_ph[DG_NPH + 2])
#define DG_NEXT_CALL() do {{ if (threadIdx.x == 0) ++dg_ph[DG_NPH + 2]; }} while (0)
#define DG_END(dst) do {{ DG_MARK({PHASES.index("other")}); if (threadIdx.x == 0) \\
    for (int k_ = 0; k_ < DG_NPH; ++k_) (dst)[k_] = (float)dg_ph[k_]; }} while (0)
"""


def _mark(name):
    return f"DG_MARK({PHASES.index(name)});"


# The landmarks of a source without its own (the parent's dgrad_kernel, on
# dgemm in tile_common.cuh): (file, pattern, replacement) each made exactly
# once. Its cotangent_out becomes two loops in the copy, the masks read into
# the tile and then the tile stored to the stream, so that the two are
# timed apart.
_COTANGENT_OUT = f"""__device__ void cotangent_out(bf16* tile, int n, const bf16* __restrict__ acts, long long as,
                              int acol, bf16* __restrict__ gp, long long gs, int gcol,
                              float* bsum, long long g0, int nrows) {{
  __syncthreads();
  {_mark("mask_reads")}
  const int nv = n / 8;
  for (int v = threadIdx.x; v < MT * nv; v += THREADS) {{
    const int r = v / nv, c = (v % nv) * 8;
    uint4 t8 = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows) {{
      t8 = *reinterpret_cast<const uint4*>(tile + r * LDA + c);
      if (MASK) {{
        const uint4 a8 = *reinterpret_cast<const uint4*>(acts + (g0 + r) * as + acol + c);
        const bf16* ae = reinterpret_cast<const bf16*>(&a8);
        bf16* te = reinterpret_cast<bf16*>(&t8);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (!(bf(ae[j]) > 0.f)) te[j] = __float2bfloat16_rn(0.f);
      }}
    }}
    *reinterpret_cast<uint4*>(tile + r * LDA + c) = t8;
  }}
  __syncthreads();
  {_mark("stores")}
  for (int v = threadIdx.x; v < nrows * nv; v += THREADS) {{
    const int r = v / nv, c = (v % nv) * 8;
    *reinterpret_cast<uint4*>(gp + (g0 + r) * gs + gcol + c) =
        *reinterpret_cast<const uint4*>(tile + r * LDA + c);
  }}
  __syncthreads();
  {_mark("colsums")}
  for (int c = threadIdx.x; c < n; c += THREADS) {{
    float s = 0.f;
    for (int r = 0; r < nrows; ++r) s += bf(tile[r * LDA + c]);
    bsum[c] += s;
  }}
}}

"""
PARENT_SUBS = [
    ("fused_render.cu", r"__device__ void cotangent_out\(.*?\n}\n\n", _COTANGENT_OUT),
    ("fused_render.cu", r"  for \(int e = tid; e < NB; e \+= THREADS\) bsum\[e\] = 0\.f;\n",
     "  DG_BEGIN();\n  for (int e = tid; e < NB; e += THREADS) bsum[e] = 0.f;\n"),
    ("fused_render.cu", r"    __syncthreads\(\);\n    for \(int e = tid; e < MT \* 8; e \+= THREADS\) \{\n",
     "    __syncthreads();\n    DG_TILE();\n    for (int e = tid; e < MT * 8; e += THREADS) {\n"),
    ("fused_render.cu", r"      // transient output layer: g_t",
     f"      {_mark('head_loops')}\n      // transient output layer: g_t"),
    ("fused_render.cu", r"      __syncthreads\(\);\n      // X = \[g_bott",
     f"      __syncthreads();\n      {_mark('head_loops')}\n      // X = [g_bott"),
    ("fused_render.cu", r"      __syncthreads\(\);\n      for \(int e = tid; e < MT \* W; e \+= THREADS\) \{           // \+ round",
     f"      __syncthreads();\n      {_mark('head_loops')}\n"
     "      for (int e = tid; e < MT * W; e += THREADS) {           // + round"),
    ("fused_render.cu", r"      for \(int e = tid; e < MT \* W; e \+= THREADS\) \{           // g_h = round",
     f"      {_mark('head_loops')}\n"
     "      for (int e = tid; e < MT * W; e += THREADS) {           // g_h = round"),
    ("fused_render.cu", r"    __syncthreads\(\);\n    // d_xb = g_pe",
     f"    __syncthreads();\n    {_mark('pe_bwd')}\n    // d_xb = g_pe"),
    ("fused_render.cu", r"    __syncthreads\(\);\n    for \(int lr = tid; lr < nray; lr \+= THREADS\) \{   // per-ray",
     f"    __syncthreads();\n    {_mark('ray_sums')}\n"
     "    for (int lr = tid; lr < nray; lr += THREADS) {   // per-ray"),
    ("fused_render.cu",
     r"  for \(int e = tid; e < NB; e \+= THREADS\) bias_part\[\(long long\)blockIdx\.x \* NB \+ e\] = bsum\[e\];\n}",
     "  for (int e = tid; e < NB; e += THREADS) bias_part[(long long)blockIdx.x * NB + e] = bsum[e];\n"
     "  __syncthreads();\n  DG_END(bias_part + (long long)blockIdx.x * NB);\n}"),
    ("tile_common.cuh", r"  ring_prologue\(total, stage\);\n  int q = 0;\n  for \(int n0 = 0; n0 < n_dim; n0 \+= NC\) \{\n    const int nh",
     "  __syncthreads();\n  DG_PRO();\n  ring_prologue(total, stage);\n  int q = 0;\n"
     "  for (int n0 = 0; n0 < n_dim; n0 += NC) {\n    const int nh"),
    ("tile_common.cuh", r"      const uint32_t st = ring_next\(q\+\+, total, ring, stage\);\n      // MN-major B",
     "      const uint32_t st = ring_next(q++, total, ring, stage);\n      if (q == 1) DG_MM();\n"
     "      // MN-major B"),
    ("tile_common.cuh", r"        \*p0 = __floats2bfloat162_rn\(v0, v1\);\n        \*p1 = __floats2bfloat162_rn\(v2, v3\);\n      }\n  }\n}",
     "        *p0 = __floats2bfloat162_rn(v0, v1);\n        *p1 = __floats2bfloat162_rn(v2, v3);\n"
     "      }\n  }\n  DG_NEXT_CALL();\n}"),
]


def phase_source(source=None):
    """An instrumented copy of the csrc/ that holds ``source`` (by default
    this tree's fused_render.cu), under _build/dgrad_phases/: the copy's
    fused_render.cu. A source with its own landmarks (DG_MARK) gets the
    prelude that defines them; one without (a parent's) gets PARENT_SUBS
    too."""
    src = Path(source or _build.SOURCE)
    text = src.read_text()
    tag = "this" if "DG_MARK(" in text else "parent"
    dst = _build.BUILD_DIR / "dgrad_phases" / tag
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src.parent, dst)
    files = {"fused_render.cu": text, "tile_common.cuh": (dst / "tile_common.cuh").read_text()}
    if tag == "parent":
        for name, pattern, repl in PARENT_SUBS:
            files[name], n = re.subn(pattern, lambda _, repl=repl: repl, files[name], flags=re.S)
            if n != 1:
                raise RuntimeError(f"{name} matches {pattern!r} {n} times, not once")
    files["fused_render.cu"] = PHASE_PRELUDE + files["fused_render.cu"]
    for name, body in files.items():
        (dst / name).write_text(body)
    return dst / "fused_render.cu"


def dgrad_tiles(r, kpad):
    """128-row tiles of a ray backward's dgrad pass: units of whole rays,
    each unit's samples in tiles."""
    rpb = fr.rays_per_unit(kpad)
    return sum(-(-min(rpb, r - ray0) * kpad // 128) for ray0 in range(0, r, rpb))


def dgrad_phases(source=None, reps=3, device=None, built=None, ops=("camera",)):
    """{op: {phase: clock cycles a tile, "total": ...}} of the saved
    backwards' dgrad pass at a training batch (``ops``: "camera" and / or
    "shadow"), from the instrumented copy of ``source``'s csrc/ (``built``:
    that copy's fused_render.cu, already built), the phases a block's
    thread 0 timed summed over the blocks and divided by the tiles. Only
    phases that took time are listed; prologue_c / products_c are named by
    the chain's call (CHAIN_CALLS)."""
    dev = resolve_device(device)
    src = Path(built or phase_source(source))
    _build.build(src)
    kw, _ = bench_weights(dev)
    cam, gacc, sh, ggeo = training_batch(dev)
    default = _build.SOURCE
    out = {}
    try:
        for name, args, g in (("camera", cam, gacc), ("shadow", sh, ggeo)):
            if name not in ops:
                continue
            camera = name == "camera"
            _build.SOURCE = default
            _build.load_library.cache_clear()
            acts = (fr.camera_forward_save if camera else fr.shadow_forward_save)(kw, *args)[1]
            _build.SOURCE = src
            _build.load_library.cache_clear()
            bwd = fr.camera_backward_saved if camera else fr.shadow_backward_saved
            for _ in range(reps):
                dbias = bwd(kw, *args, g, acts)[1]
            tiles = dgrad_tiles(args[0].shape[0], fr.kpad_of(args[1].shape[1]))
            cyc = (dbias[:_NPH].double() / tiles).tolist()
            calls = CHAIN_CALLS[camera]
            named = {}
            for i, p in enumerate(PHASES):
                if i >= _PRO0:
                    kind, c = p.rsplit("_", 1)
                    if int(c) >= len(calls):
                        continue
                    p = f"{kind}_{calls[int(c)]}"
                if cyc[i] > 0:
                    named[p] = cyc[i]
            named["total"] = sum(cyc)
            out[name] = named
    finally:
        _build.SOURCE = default
        _build.load_library.cache_clear()
    return out

def stream_layout(camera, r, kpad, saved):
    """The library's layout of a backward's streams in its workspace: {acts
    (byte offset, None when saved), gpre (byte offset), act_cols, cot_cols,
    splits, chunk, nblocks}."""
    out = (ctypes.c_longlong * 7)()
    _build.load_library().eonerf_bwd_stream_layout(int(camera), r, kpad, int(saved),
                                                    ctypes.cast(out, ctypes.c_void_p))
    lay = dict(zip(("acts", "gpre", "act_cols", "cot_cols", "splits", "chunk", "nblocks"), out))
    lay["acts"] = None if lay["acts"] < 0 else lay["acts"]
    return lay


def workspace_streams(ws, camera, r, kpad, acts=None):
    """The activation and cotangent streams (R*KPAD rows, bf16 views) that a
    backward of r rays (or points, kpad 1) left in its workspace ``ws``;
    ``acts``: the saved stream, which the workspace then does not hold."""
    lay = stream_layout(camera, r, kpad, acts is not None)
    s = r * kpad

    def view(off, cols):
        return ws[off:off + s * cols * 2].view(BF16).view(s, cols)
    if acts is None:
        acts = view(lay["acts"], lay["act_cols"])
    return acts, view(lay["gpre"], lay["cot_cols"])


def wgrad_alone(camera, acts, gpre, heads_only=False):
    """The kernels' wgrad pass alone (wgrad_kernel, then the fixed-order
    reduction of the matrices) on the streams ``acts`` and ``gpre`` (S rows
    each, split as a backward of S rows is): the packed float32 matrix
    gradients (``heads_only``: the tiles past the trunk, as int8_full's
    backward runs them; the trunk's entries stay zero). Measurement and
    tests; CUDA tensors only."""
    s, dev = acts.shape[0], acts.device
    cols = STREAM_COLS[bool(camera)]
    for name, t, c in (("acts", acts, cols[0]), ("gpre", gpre, cols[1])):
        if t.dtype != BF16 or tuple(t.shape) != (s, c) or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous bfloat16 ({s}, {c}) on the card, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    lib = _build.load_library()
    wpart = torch.empty((lib.eonerf_wgrad_partial_bytes(int(camera), s),), dtype=torch.uint8,
                        device=dev)
    dmats = torch.zeros((ff.MAT_ELEMENTS,), dtype=torch.float32, device=dev)
    ff.launch("eonerf_wgrad", "wgrad pass launch", dev, int(camera), int(heads_only), acts, gpre,
              s, wpart, dmats)
    return dmats


def _col_span(ranges):
    """Columns covered by a set of [start, end) ranges."""
    return len({c for a, b in ranges for c in range(a, b)})


def pass_bounds(camera, r, kpad, lay):
    """Each launch of a saved backward of r rays x kpad samples: {pass:
    (least ms on an H100 SXM, "operations" | "bytes")}. Operations: the
    multiply-adds of the pass on every stream row (dgrad and wgrad every
    matrix, the first pass the heads) at the bf16 peak. Bytes: each stream
    column the pass needs read once and each it writes written once, the
    f32 head cotangents, partial sums and gradients, the per-ray and
    per-sample inputs and the weights, at 3.35 TB/s."""
    s = r * kpad
    jobs = wgrad_jobs(camera)
    macs = sum(i * o for i, o, _, _ in jobs)
    head_macs = sum(i * o for i, o, _, _ in jobs[8:])
    a_cols = _col_span([(a, a + i) for i, _, a, _ in jobs])
    g_cols = _col_span([(b, b + o) for _, o, _, b in jobs])
    n_mat = ff.MAT_ELEMENTS if camera else ff.DENSITY_MAT_ELEMENTS
    n_bias = ff.BIAS_ELEMENTS if camera else ff.DENSITY_BIAS_ELEMENTS
    weights = n_mat * 2 + n_bias * 4
    per_ray = r * (fr.RAYIN_COLS * 4 + (fr.ACC_COLS * 4 if camera else 4))
    per_sample = s * 4 * (2 if camera else 3)        # z, deltam (, mask)
    head_cols = STREAM_COLS[True][0] - _A_BOTT if camera else 0
    mask_cols = 8 * 256 + (128 + 512 if camera else 0)   # h0..h7 (, albedo hidden, t0..t3)
    ops = {"first": head_macs, "dgrad": macs, "wgrad": macs, "reduce": 0}
    nbytes = {
        "first": per_ray + per_sample + weights + s * 2 * (256 + head_cols) + s * HG * 4,
        "dgrad": (per_ray + per_sample + weights + s * 2 * (mask_cols + g_cols) + s * HG * 4
                  + lay["nblocks"] * n_bias * 4 + r * fr.RAYIN_COLS * 4),
        "wgrad": s * 2 * (a_cols + g_cols) + lay["splits"] * n_mat * 4,
        "reduce": (lay["splits"] + 1) * n_mat * 4 + (lay["nblocks"] + 1) * n_bias * 4}
    out = {}
    for p in PASSES:
        ops_ms = 2.0 * ops[p] * s / PEAK_BF16 * 1e3
        bytes_ms = nbytes[p] / PEAK_BYTES * 1e3
        out[p] = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
    return out, nbytes



# Cost attribution: copies of csrc/ with one of the dgrad kernel's costs
# taken out (their outputs are wrong; only their times mean something),
# made by bench/q8_trunk.py's source_copy
DGRAD_ATTRIBUTION = {
    "no_masks": [   # no mask copies (the epilogue applies whatever the tile holds)
        (r"    asm volatile\(\"cp\.async\.cg\.shared\.global\.L2::cache_hint",
         "    if (r < 0) asm volatile(\"cp.async.cg.shared.global.L2::cache_hint")],
    "no_overlap": [   # every chunk's products waited for before the next barrier
        (r"constexpr int WG_INFLIGHT = 1;", "constexpr int WG_INFLIGHT = 0;")],
    "no_stores": [  # no cotangent rows to the stream
        (r"              if \(v < units\)\n                __stcs",
         "              if (v < 0)\n                __stcs")],
    "no_colsums": [  # no bias-gradient column sums
        (r"  const int lane = threadIdx\.x & 31, g = lane >> 2, t = lane & 3;\n  float y\[16\], z\[8\], w\[4\];",
         "  if (colpart != nullptr) return;\n  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;\n"
         "  float y[16], z[8], w[4];")],
    "no_pe": [      # no PE backward
        (r"    if \(TRUNK\) \{\n      const int r = tid & \(MT - 1\);",
         "    if (false) {\n      const int r = tid & (MT - 1);")],
}


def dgrad_attribution(reps=10, device=None):
    """{copy: [(camera ms, shadow ms) a turn]} of the dgrad pass alone
    (saved backwards at the training batch) in each attribution copy's
    build and this tree's as it is ("as_is"), in turns (the copies in
    order, then in reverse), on the streams and head cotangents of this
    tree's first pass."""
    from eonerf_code_tpu_torch.bench.q8_trunk import source_copy
    dev = resolve_device(device)
    builds = {"as_is": source_copy("dgrad_as_is", [])}
    builds.update({tag: source_copy(f"dgrad_{tag}", subs) for tag, subs in DGRAD_ATTRIBUTION.items()})
    with concurrent.futures.ThreadPoolExecutor(8) as pool:   # every nvcc started together
        list(pool.map(_build.build, builds.values()))
    kw, _ = bench_weights(dev)
    cam, gacc, sh, ggeo = training_batch(dev)
    runs = []
    for args, g, save, mask in ((cam, gacc, fr.camera_forward_save, None),
                                (sh, ggeo, fr.shadow_forward_save, sh[3])):
        acts = save(kw, *args)[1]
        run, _ = _pass_runner(kw, *args[:3], g, acts, mask)
        run(0)   # the head cotangents dgrad reads
        runs.append(run)
    default = _build.SOURCE
    times = {tag: [] for tag in builds}
    try:
        for tag in list(builds) + list(builds)[::-1]:
            _build.SOURCE = builds[tag]
            _build.load_library.cache_clear()
            times[tag].append(tuple(_event_ms(lambda run=run: run(1), reps) for run in runs))
    finally:
        _build.SOURCE = default
        _build.load_library.cache_clear()
    return times

def _event_ms(fn, iters):
    fn()   # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _pass_runner(weights, rayin, z, deltam, g, acts, mask=None):
    """(run(pass), workspace): one launch of a saved backward's pass (C
    entry ``eonerf_bwd_pass``: 0 the first pass, 1 dgrad, 2 wgrad, 3 the
    reduction) on one workspace, which the passes before it must have
    filled. Arguments as :func:`backward_pass_ms`'s."""
    camera = mask is None
    dev = rayin.device
    r, kpad = fr._check_call(weights, rayin, z, ("deltam", deltam, z.shape),
                             ("g", g, (z.shape[0], fr.ACC_COLS) if camera else (z.shape[0],)))
    fr._stream_for(camera, r, kpad, dev, acts)
    ws = fr._workspace(camera, r, kpad, dev, saved=True)
    grads = fr._zero_grads(r, dev)
    args = (rayin, fr._padded(z, kpad), fr._padded(deltam, kpad),
            None if camera else fr._padded(mask, kpad), g, weights.mats, weights.biases, acts, ws,
            *grads, r, kpad)

    def run(p):
        ff.launch("eonerf_bwd_pass", f"backward pass {p}", dev, int(camera), p, *args)
    return run, ws


def backward_pass_ms(weights, rayin, z, deltam, g, acts, mask=None, iters=10):
    """The saved camera backward (``mask`` None, ``g`` the (R, 8) gacc) or
    shadow backward (``g`` the (R,) ggeo) on the stream ``acts`` of its save
    forward, launch by launch on the card: each of the four timed alone with
    CUDA events over ``iters`` launches after a warm-up that fills what the
    next one reads, and the wgrad and dgrad passes' library yardsticks on the
    workspace's own streams. Returns {"ms": {pass: ms}, "library_wgrad_ms",
    "library_dgrad_ms", "bound_ms": {pass: ms}, "bound_by": {pass: ...},
    "bound_share": {pass: bound over ms}, "wgrad_bytes",
    "wgrad_bytes_per_s"}. Measurement launches: not counted in the
    wrappers' ``launches``."""
    camera = mask is None
    if rayin.device.type != "cuda":
        raise RuntimeError("backward_pass_ms times the kernels: CUDA tensors only")
    r, kpad = rayin.shape[0], fr.kpad_of(z.shape[1])
    run, ws = _pass_runner(weights, rayin, z, deltam, g, acts, mask)
    ms = {name: _event_ms(lambda p=p: run(p), iters) for p, name in enumerate(PASSES)}
    streams = workspace_streams(ws, camera, r, kpad, acts)
    lib_wgrad = wgrad_library(camera, *streams)
    lib_dgrad = dgrad_library(camera, weights.mats, *streams)
    lay = stream_layout(camera, r, kpad, True)
    bounds, nbytes = pass_bounds(camera, r, kpad, lay)
    return {"ms": ms, "library_wgrad_ms": _event_ms(lib_wgrad, iters),
            "library_dgrad_ms": _event_ms(lib_dgrad, iters),
            "bound_ms": {p: b[0] for p, b in bounds.items()},
            "bound_by": {p: b[1] for p, b in bounds.items()},
            "bound_share": {p: b[0] / ms[p] for p, b in bounds.items()},
            "wgrad_bytes": nbytes["wgrad"],
            "wgrad_bytes_per_s": nbytes["wgrad"] / (ms["wgrad"] * 1e-3)}


def training_batch(device, r=1024, k=127, k_shadow=63, seed=3):
    """Seeded rays of a training batch's shapes for the saved pair: (camera
    (rayin, z, deltam), gacc, shadow (rayin, z, deltam, mask), ggeo)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rays(kk):
        o = torch.rand((r, 3), generator=gen, device=device) * 1.2 - 0.6
        o[:, 2] = 0.99
        d = F.normalize(torch.tensor([0.02, 0.01, -1.0], device=device), dim=0)
        emb = torch.randn((r, 4), generator=gen, device=device)
        rayin = torch.cat([o, d.expand(r, 3), emb, torch.zeros((r, 6), device=device)], 1)
        z = torch.sort(torch.rand((r, kk), generator=gen, device=device) * 2.0, dim=1)[0]
        dm = torch.diff(z, dim=1, append=torch.full((r, 1), 2.0, device=device))
        return rayin.contiguous(), z.contiguous(), dm.contiguous()
    cam, sh = rays(k), rays(k_shadow)
    gacc = torch.randn((r, fr.ACC_COLS), generator=gen, device=device)
    ggeo = torch.randn((r,), generator=gen, device=device)
    return cam, gacc, (*sh, torch.ones_like(sh[1])), ggeo


def main(iters=10, device=None):
    """Print one JSON line a saved backward (camera, shadow) with its
    launches' times, the wgrad yardstick and the bounds; returns them."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the passes are timed on the card only")
    kw, _ = bench_weights(dev)
    cam, gacc, sh, ggeo = training_batch(dev)
    out = {}
    for name, args, g, fwd_save in (("camera", cam, gacc, fr.camera_forward_save),
                                    ("shadow", sh, ggeo, fr.shadow_forward_save)):
        acts = fwd_save(kw, *args)[1]
        mask = None if name == "camera" else args[3]
        out[name] = backward_pass_ms(kw, *args[:3], g, acts, mask, iters)
        print(json.dumps({"backward": f"{name}_saved", "rays": args[0].shape[0],
                          "samples": args[1].shape[1], **out[name],
                          "device": torch.cuda.get_device_name(dev)}), flush=True)
    return out


if __name__ == "__main__":
    if sys.argv[1:2] == ["attribution"]:
        for tag, turns in dgrad_attribution().items():
            print(json.dumps({"dgrad_copy": tag, "turns_ms_camera_shadow": turns,
                              "device": torch.cuda.get_device_name()}), flush=True)
    elif sys.argv[1:2] == ["phases"]:
        res = dgrad_phases(sys.argv[2] if len(sys.argv) > 2 else None)
        for op, cycles in res.items():
            print(json.dumps({"dgrad_phases": op, "cycles_per_tile": cycles,
                              "device": torch.cuda.get_device_name()}), flush=True)
    else:
        main(*[int(a) for a in sys.argv[1:2]])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
