"""The plain camera, shadow and coarse forwards on one CUDA card, at a
render chunk's shapes and with its real cube masks (4096 rays of the
512x512 nadir sweep that chip_smoke.py renders: camera K=127 and, after
sample_pdf, K=143; shadow K=63, about a quarter of its samples in the cube;
coarse K=95), the save forwards (the streamed forward's save mode) on a
training batch of its rays (SAVE_CASES: the first 1024, camera K=127 and
143, shadow K=63), and the per-point field and density forwards on the
chunk's points (POINT_CASES: the field on its 520,192 camera-sample points,
each with its ray's embedding, and on a training batch's 130,048; the
density on its 258,048 shadow-sample points, on a batch's 64,512 and on the
entropy probe's 131,072).

    python -m eonerf_code_tpu_torch.bench.stream_fwd l2
    python -m eonerf_code_tpu_torch.bench.stream_fwd phases [OTHER/fused_render.cu] [CASE ...]
    python -m eonerf_code_tpu_torch.bench.stream_fwd turns OTHER/fused_render.cu [reps]
    python -m eonerf_code_tpu_torch.bench.stream_fwd configs [NAME ...]
    python -m eonerf_code_tpu_torch.bench.stream_fwd attribution [NAME ...]

`l2` measures the L2 read rate that a weight stream sees when every SM
reads the same L2-resident buffer of the camera's weight sequence (84
chunks of 16 KB), by bulk copies (the TMA, as the streamed forwards'
producer warp reads it) and by 16-byte loads (kernel_variants.cu
l2_read_kernel), and from it the weight staging's time in the design
before the streamed forwards (each 128-row tile re-staging every weight
matrix) at the render chunk's shapes, and the rate at which each streamed
forward's ring reads its weight stream on the chunk (the tiles' chunks of
16 KB over the call's CUDA-event time, its plan launches included), the
save mode's beside the plain mode's. `phases` prints the clock
cycles one thread of each block spends a tile between the landmarks of a
forward: this tree's stream_fwd_kernel (its FS_* landmarks, empty in the
production source; the save mode's stream stores are the phase stores,
beside the ring's wait) or, given another tree's
fused_render.cu that lacks them, that tree's fused_fwd_kernel<MODE, false>
(the save cases: its save forward, fused_fwd_kernel<MODE, false, false,
true>, in a tree before the save mode) on tile_common.cuh's gemm
(landmarks put in by PARENT_SUBS): per gemm call its ring prologue, its
ring waits (barriers), its products and its epilogue; for the point cases
of a tree whose point forwards are point_kernel<FIELD, false> (one block
a 128-point tile, launch_point), that kernel on gemm, phased by the same
PARENT_SUBS. `turns` times this tree's forwards and the render sweeps
(render_diag, with ray entropy and the nadir diagnostics, beside the
others) against another tree's build in turns (other, this, this,
other). `configs` builds copies of this tree
with another configuration of the kernel (CONFIGS), holds their outputs
to this tree's bit for bit and times them in turns with their phases;
`attribution` does the same with copies that each take one cost out
(ATTRIBUTION; their outputs wrong by design).
Every line ends with the card's name.
"""

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from eonerf_code_tpu_torch.bench.csrc_copies import (
    build_all,
    in_turns,
    source_copy,
    summed_phase_prelude,
    using,
)
from eonerf_code_tpu_torch.bench.kernel_variants import resolve_device, time_ms
from eonerf_code_tpu_torch.ops import _build
from eonerf_code_tpu_torch.ops import fused_field as ff
from eonerf_code_tpu_torch.ops import fused_render as fr

N_CHUNK = 4096
N_BATCH = 1024                           # rays of a training batch
N_PROBE_RAYS, N_PROBE_SAMPLES = 2048, 64   # the trainer's entropy probe
POINT_CASES = ("field", "field_batch", "density", "density_probe", "density_batch")
SAVE_CASES = ("camera_save", "camera_save_k143", "shadow_save")
PHASE_CASES = ("camera", "camera_k143", "shadow")   # the ray cases phased by default
CHUNK_BYTES = 16384
# bf16 elements a 128-row tile of the earlier design staged through its
# ring: the camera's trunk, bottleneck, albedo hidden, transient 0..3 (the
# 1- and 3-wide heads read from L1 beside them), the density trunk
STAGED_ELEMENTS = {True: 491520 + 65536 + 32768 + 40960 + 3 * 16384, False: 491520}


def _field_and_sweep(device):
    """The seeded full-width bf16 EONerfField of chip_smoke.py's render
    phases and the rays of its 512x512 nadir sweep."""
    from eonerf_code_tpu_torch.data.rays import satrays_from_tensor
    from eonerf_code_tpu_torch.models.eonerf import EONerfField
    from eonerf_code_tpu_torch.render.nadir import nadir_rays_with_sun

    field = EONerfField(20, compute_dtype=torch.bfloat16, device=device,
                        generator=torch.Generator().manual_seed(0))
    rays_np, _, _ = nadir_rays_with_sun(512, 512, 35.0, 140.0, np.array([256.0, 256.0, 60.0]))
    return field, satrays_from_tensor(torch.from_numpy(rays_np).to(device),
                                      torch.zeros(rays_np.shape[0], dtype=torch.long,
                                                  device=device))


def render_chunk(device, seed=1):
    """(packed weights, {case: (op, inputs)}) of a render chunk as
    chip_smoke.py's phase kernels builds it: a seeded full-width bf16
    EONerfField, 4096 rays from the middle of the 512x512 nadir sweep, its
    stratified camera samples (K=127) and hierarchical ones (96 + 48 after
    sample_pdf, K=143), shadow rays from plausible surface points (K=63) and
    the coarse pass's 96 stratified samples (K=95), every deltam with the
    cube mask and the 1e10 last-valid sentinel; SAVE_CASES, the save
    forwards on the first N_BATCH of those camera (K=127 and 143) and
    shadow rays; and POINT_CASES, the per-point forwards on the chunk's
    points as chip_smoke.py builds them (every point counts, in the cube or
    not)."""
    from eonerf_code_tpu_torch.models.fused import make_render_field
    from eonerf_code_tpu_torch.ops.fused_field import pack_params
    from eonerf_code_tpu_torch.ops.sampling import set_last_valid
    from eonerf_code_tpu_torch.render import satellite as sat

    field, rays_all = _field_and_sweep(device)
    rf = make_render_field(field)
    with torch.no_grad():
        kw = ff.pack_kernel_weights(pack_params(field), torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(seed)
    mid = rays_all.origins.shape[0] // 2
    sub = sat.SatRays(*(x[mid:mid + N_CHUNK] for x in rays_all))

    def camera(cfg, field=None):
        with torch.no_grad():
            zm, delta, _, mask = sat._camera_samples(sub.origins, sub.viewdirs, sub.t_near, cfg,
                                                     gen, field=field)
        return zm.contiguous(), (set_last_valid(delta, mask, cfg.inf_delta) * mask).contiguous()

    cfg = sat.RenderConfig(n_samples=128, sc_n_samples=64)
    z_mid, deltam = camera(cfg)
    emb = torch.randn((N_CHUNK, 4), generator=gen, device=device)
    zeros6 = torch.zeros((N_CHUNK, 6), device=device)
    rayin = torch.cat([sub.origins, sub.viewdirs, emb, zeros6], dim=1).contiguous()
    sc_o = sub.origins + sub.viewdirs * (0.5 + z_mid[:, :1])
    _, sc_z, sc_delta, sc_mask = sat._sample_block(
        sc_o, -sub.sundirs, torch.zeros_like(sub.t_near), cfg.sc_n_samples, cfg.ray_span, True,
        cfg.cube_bound, gen)
    rayin_sc = torch.cat([sc_o, -sub.sundirs, torch.zeros((N_CHUNK, 10), device=device)],
                         dim=1).contiguous()
    h_mid, h_dm = camera(sat.RenderConfig(n_samples=96, n_importance=48, sc_n_samples=64), rf)
    c_mid, c_dm = camera(sat.RenderConfig(n_samples=96))
    rayin_c = torch.cat([sub.origins, sub.viewdirs, torch.zeros((N_CHUNK, 10), device=device)],
                        dim=1).contiguous()

    def points(o, d, z):
        return (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3).contiguous()

    pos_f = points(sub.origins, sub.viewdirs, z_mid)
    emb_f = emb[:, None, :].expand(-1, z_mid.shape[1], -1).reshape(-1, 4).contiguous()
    sc_pos = points(sc_o, -sub.sundirs, sc_z)
    # the entropy probe: 64 uniform samples on [near, far] of 2048 rays
    probe = sat.SatRays(*(x[:N_PROBE_RAYS] for x in sub))
    tm = (torch.arange(N_PROBE_SAMPLES, device=device) + 0.5) / N_PROBE_SAMPLES
    pos_p = points(probe.origins, probe.viewdirs,
                   probe.t_near[:, None] + (probe.t_far - probe.t_near)[:, None] * tm)
    n_fb, n_db = N_BATCH * z_mid.shape[1], N_BATCH * sc_z.shape[1]
    point_calls = {"field": (ff.field_forward, (pos_f, emb_f)),
                   "field_batch": (ff.field_forward, (pos_f[:n_fb], emb_f[:n_fb])),
                   "density": (ff.density_forward, (sc_pos,)),
                   "density_probe": (ff.density_forward, (pos_p,)),
                   "density_batch": (ff.density_forward, (sc_pos[:n_db],))}
    ray_calls = {"camera": (fr.camera_forward, (rayin, z_mid, deltam)),
                 "camera_k143": (fr.camera_forward, (rayin, h_mid, h_dm)),
                 "shadow": (fr.shadow_forward, (rayin_sc, sc_z.contiguous(),
                                                (sc_delta * sc_mask).contiguous(),
                                                sc_mask.float().contiguous())),
                 "coarse": (fr.coarse_forward, (rayin_c, c_mid, c_dm))}

    def batch(case):   # a training batch: the case's first N_BATCH rays
        return tuple(x[:N_BATCH].contiguous() for x in ray_calls[case][1])
    save_calls = {"camera_save": (fr.camera_forward_save, batch("camera")),
                  "camera_save_k143": (fr.camera_forward_save, batch("camera_k143")),
                  "shadow_save": (fr.shadow_forward_save, batch("shadow"))}
    return kw, {**point_calls, **ray_calls, **save_calls}


def compared(out):
    """A forward's outputs as the tensors two builds must give bit for bit:
    as they are, but a save forward's stream (its second output, (R*KPAD,
    act_stream_cols) bfloat16) cut to the columns that forward writes on
    every row, padding rows included: the PE and h0..h7, columns 0..2111
    (the camera's head columns are the backward's, and torch.empty's
    before it)."""
    out = list(out) if isinstance(out, (tuple, list)) else [out]
    if len(out) == 2 and out[1].dtype == torch.bfloat16 and out[1].is_cuda:
        out[1] = out[1][:, :fr.act_stream_cols(False)]
    return [t.clone() for t in out]


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


# ---------------------------------------------------------------------------
# step 1: the L2 read rate
# ---------------------------------------------------------------------------

def l2_rate(device=None, reps=64, iters=5):
    """{mode: GB/s} of every SM reading the camera's weight sequence (84
    chunks of 16 KB) from L2 `reps` times, mode "bulk" (TMA bulk copies)
    and "loads" (ld.global.cg); also each mode on one SM alone."""
    dev = resolve_device(device)
    lib = _build.load_variants_library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nbytes = fr.STREAM_CHUNKS[True] * CHUNK_BYTES
    src = torch.randint(0, 255, (nbytes,), dtype=torch.uint8, device=dev)
    out = torch.zeros((sms,), dtype=torch.int32, device=dev)
    rates = {}
    for mode, name in ((1, "bulk"), (0, "loads")):
        for blocks, tag in ((sms, ""), (1, "_one_sm")):
            def run():
                _build.check(lib.kv_l2_read(mode, src.data_ptr(), nbytes, reps, blocks,
                                            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
                             "l2_read_kernel", lib.kv_error_string)
            ms = time_ms(run, iters, dev)
            rates[name + tag] = blocks * nbytes * reps / (ms * 1e-3) / 1e9
    return {"bytes": nbytes, "sms": sms, "gb_per_s": rates}


def staged_traffic(rate_gbs, tiles, camera):
    """(GB read from L2, ms at rate_gbs) of the earlier design's weight
    staging over `tiles` 128-row tiles, each re-staging STAGED_ELEMENTS."""
    gb = tiles * STAGED_ELEMENTS[camera] * 2 / 1e9
    return gb, gb / rate_gbs * 1e3


# the ray forwards whose ring rates `l2` reads: the plain mode's and the
# save mode's of the same op
RING_CASES = ("camera", "camera_save", "shadow", "shadow_save")


def ring_rates(device=None, reps=20):
    """{case: {"tiles", "weight_gb", "ms", "gb_per_s"}} of RING_CASES on
    the render chunk: the weight stream a call's ring reads (each tile its
    op's STREAM_CHUNKS chunks of 16 KB, from L2) over the call's CUDA-event
    time (the mean of `reps` calls, its plan launches included), so the
    save mode's rate, whose stream stores share L2 with that read, stands
    beside the plain mode's."""
    dev = resolve_device(device)
    kw, calls = render_chunk(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for name in RING_CASES:
        op, args = calls[name]
        kpad = fr.kpad_of(args[1].shape[1])
        tiles = stream_tiles(fr._padded(args[2], kpad), sms, name in SAVE_CASES)
        gb = tiles * fr.STREAM_CHUNKS[name.startswith("camera")] * CHUNK_BYTES / 1e9
        ms = time_ms(lambda op=op, args=args: op(kw, *args), reps, dev)
        out[name] = {"tiles": tiles, "weight_gb": gb, "ms": ms, "gb_per_s": gb / (ms * 1e-3)}
    return out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

# this tree's stream_fwd_kernel: its FS_MARK phases
PHASES = ("other", "meta", "pe", "wait", "products", "epilogue", "heads", "results",
          "composite", "stores")
# the earlier design's fused_fwd_kernel: five phases, then four a gemm call
# (ring prologue, ring waits, products, epilogue), 14 calls a camera tile
# (the trunk's 8, the heads' 6)
PARENT_PHASES = ("other", "pe", "heads", "composite", "tile_end") + tuple(
    f"{p}_{c}" for c in range(14) for p in ("prologue", "wait", "products", "epilogue"))


def _sub(pattern, repl, name="fused_render.cu"):
    return (name, re.escape(pattern), repl)


# The landmarks of a tree without its own (fused_fwd_kernel<MODE, false> on
# gemm, as in the tree before the streamed forwards, and point_kernel, the
# per-point forwards before their point modes and the backwards' first pass
# since): (file, pattern, replacement) each made exactly once. In
# point_kernel the outputs' stores after FW_END are not phased.
PARENT_SUBS = [
    _sub("  const int nrows = N - p0 < MT ? (int)(N - p0) : MT;\n",
         "  const int nrows = N - p0 < MT ? (int)(N - p0) : MT;\n  FW_BEGIN();\n  FW_TILE();\n"
         "  FW_MARK(1);\n"),
    _sub("    bufY[r * LDA + W + c] = pv;\n  }\n",
         "    bufY[r * LDA + W + c] = pv;\n  }\n  FW_MARK(0);\n"),
    _sub("  for (int r = threadIdx.x; r < nrows; r += THREADS)\n    res[r * RES] = softplus(",
         "  FW_MARK(2);\n  for (int r = threadIdx.x; r < nrows; r += THREADS)\n"
         "    res[r * RES] = softplus("),
    _sub("  for (int e = threadIdx.x; e < nrows * NO; e += THREADS) {\n",
         "  FW_END();\n  for (int e = threadIdx.x; e < nrows * NO; e += THREADS) {\n"),
    _sub("  const int S = nray * KPAD;\n\n  for (int s0 = 0; s0 < S; s0 += MT) {\n",
         "  const int S = nray * KPAD;\n  FW_BEGIN();\n\n  for (int s0 = 0; s0 < S; s0 += MT) {\n"
         "    FW_TILE();\n"),
    _sub("      // positional encoding into the PE columns of both tiles; rows past the\n",
         "      FW_MARK(1);\n      // positional encoding into the PE columns of both tiles; rows"
         " past the\n"),
    _sub("      P = trunk_tile<", "      FW_MARK(0);\n      P = trunk_tile<"),
    _sub("    for (int r = threadIdx.x; r < nrows; r += THREADS)\n      res[(s0 + r) * RES] =",
         "    FW_MARK(2);\n    for (int r = threadIdx.x; r < nrows; r += THREADS)\n"
         "      res[(s0 + r) * RES] ="),
    _sub("  // the embedding into Q's cols 256..259 (260..319 zero)\n",
         "  FW_MARK(2);\n  // the embedding into Q's cols 256..259 (260..319 zero)\n"),
    _sub("  for (int r = threadIdx.x; r < nrows; r += THREADS)\n    for (int c = 0; c < 3; ++c)\n",
         "  FW_MARK(2);\n  for (int r = threadIdx.x; r < nrows; r += THREADS)\n"
         "    for (int c = 0; c < 3; ++c)\n"),
    _sub("  for (int r = threadIdx.x; r < nrows; r += THREADS) {\n    res[r * RES + 4] =",
         "  FW_MARK(2);\n  for (int r = threadIdx.x; r < nrows; r += THREADS) {\n"
         "    res[r * RES + 4] ="),
    _sub("    __syncthreads();\n  }\n\n  // compositing (forward) or its backward",
         "    FW_MARK(4);\n    __syncthreads();\n    FW_MARK(0);\n  }\n\n  FW_MARK(3);\n"
         "  // compositing (forward) or its backward"),
    _sub("      out[(long long)ray0 * KPAD + e] = res[e * RES + 1];\n  }\n}\n",
         "      out[(long long)ray0 * KPAD + e] = res[e * RES + 1];\n  }\n  FW_END();\n}\n"),
    _sub("  ring_prologue(total, stage);\n  int q = 0;\n  for (int n0 = 0; n0 < n_dim; n0 += NC) {\n"
         "    float acc[CH][N / 2];",
         "  FW_CALL(5);\n  ring_prologue(total, stage);\n  int q = 0;\n"
         "  for (int n0 = 0; n0 < n_dim; n0 += NC) {\n    float acc[CH][N / 2];", "tile_common.cuh"),
    _sub("      const uint32_t st = ring_next(q++, total, ring, stage);\n      // K-major B",
         "      FW_CALL(6);\n      const uint32_t st = ring_next(q++, total, ring, stage);\n"
         "      FW_CALL(7);\n      // K-major B", "tile_common.cuh"),
    _sub("    }\n#pragma unroll\n    for (int c = 0; c < CH; ++c)\n#pragma unroll\n"
         "      for (int j = 0; j < N / 8; ++j) {\n        const int col = n0 + col0",
         "    }\n    FW_CALL(8);\n#pragma unroll\n    for (int c = 0; c < CH; ++c)\n#pragma unroll\n"
         "      for (int j = 0; j < N / 8; ++j) {\n        const int col = n0 + col0",
         "tile_common.cuh"),
    _sub("        *reinterpret_cast<__nv_bfloat162*>(op + 8 * LD) = __floats2bfloat162_rn(v2, v3);\n"
         "      }\n  }\n}",
         "        *reinterpret_cast<__nv_bfloat162*>(op + 8 * LD) = __floats2bfloat162_rn(v2, v3);\n"
         "      }\n  }\n  FW_MARK(0);\n  FW_NEXT_CALL();\n}", "tile_common.cuh"),
]


# in a tree before the point modes, the launch of the per-point forwards;
# before the save mode, that of the save forward
PARENT_OF = {"point": "launch_point<true, false>", "save": "launch<CAM, false, false, true>"}


def case_kind(case):
    """"point" (POINT_CASES), "save" (SAVE_CASES) or "ray" (the plain ray
    forwards)."""
    return "point" if case in POINT_CASES else ("save" if case in SAVE_CASES else "ray")


def phase_source(source=None, kind="ray"):
    """An instrumented copy of the csrc/ that holds ``source`` (by default
    this tree's fused_render.cu) for the forwards of one :func:`case_kind`:
    the copy's fused_render.cu. A source whose forwards of that kind have
    their own landmarks (FS_MARK) gets the prelude that defines them; one
    without (the design before the streamed forwards, or before their point
    modes or their save mode) gets PARENT_SUBS and the FW_ prelude."""
    src = Path(source or _build.SOURCE)
    text = src.read_text()
    marker = PARENT_OF.get(kind)
    if "FS_MARK(" in text and not (marker and marker in text):
        return source_copy("fwd_phases_this", (),
                           summed_phase_prelude("bench/stream_fwd.py", "FS", len(PHASES)), src)
    return source_copy("fwd_phases_parent", PARENT_SUBS,
                       summed_phase_prelude("bench/stream_fwd.py", "FW", len(PARENT_PHASES)), src)


def parent_tiles(r, kpad):
    """128-row tiles of the earlier design's forward: blocks of
    rays_per_unit(kpad) whole rays, each block's samples in tiles."""
    rpb = fr.rays_per_unit(kpad)
    return sum(-(-min(rpb, r - ray0) * kpad // 128) for ray0 in range(0, r, rpb))


def stream_tiles(deltam, sms, save=False):
    """128-row tiles of the streamed forward on a card of ``sms`` SMs
    (:func:`fr.stream_fwd_plan` on the call's deltam, or with ``save`` the
    save mode's :func:`fr.save_fwd_plan`)."""
    if save:
        return int(fr.save_fwd_plan(deltam.shape[0], deltam.shape[1], sms)["tiles"].sum())
    plan = fr.stream_fwd_plan(deltam.cpu(), sms)
    return int(plan["tiles"].sum())


def phases(source=None, reps=3, device=None, built=None, cases=PHASE_CASES):
    """{case: {phase: clock cycles a tile, "total": ...}} of the forwards
    at the render chunk's shapes, from the instrumented copy of
    ``source``'s csrc/ (``built``: that copy's fused_render.cu, already
    built): thread 0 of each block, summed over the blocks of `reps`
    launches and divided by their tiles. Only phases that took time are
    listed. ``cases``: cases of one :func:`case_kind`."""
    dev = resolve_device(device)
    kinds = {case_kind(c) for c in cases}
    if len(kinds) != 1:
        raise ValueError(f"phases takes cases of one kind (ray, save, point): {cases}")
    kind = kinds.pop()
    points = kind == "point"
    src = Path(built or phase_source(source, kind))
    _build.build(src)
    parent = "FW_MARK(" in src.read_text()
    names = PARENT_PHASES if parent else PHASES
    kw, calls = render_chunk(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    with using(src):
        lib = _build.load_library()
        lib.eonerf_phase_sums.argtypes = [ctypes.c_void_p, ctypes.c_int]
        sums = (ctypes.c_ulonglong * (len(names) + 1))()
        for name in cases:
            op, args = calls[name]
            op(kw, *args)
            _build.check(lib.eonerf_phase_sums(sums, 1), "phase sums")
            for _ in range(reps):
                op(kw, *args)
            _build.check(lib.eonerf_phase_sums(sums, 1), "phase sums")
            if points:   # both designs: a 128-point tile each
                tiles = reps * -(-args[0].shape[0] // 128)
            else:
                kpad = fr.kpad_of(args[1].shape[1])
                tiles = reps * (parent_tiles(args[0].shape[0], kpad) if parent
                                else stream_tiles(fr._padded(args[2], kpad), sms,
                                                  name in SAVE_CASES))
            cyc = {p: sums[i] / tiles for i, p in enumerate(names) if sums[i] > 0}
            cyc["total"] = sum(sums[i] for i in range(len(names))) / tiles
            out[name] = {"tiles_a_launch": tiles // reps, "blocks_a_launch": sums[len(names)] // reps,
                         "cycles_per_tile": cyc}
    return out


# ---------------------------------------------------------------------------
# configurations of this tree's kernel
# ---------------------------------------------------------------------------

# name -> substitutions into this tree's fused_render.cu
CONFIGS = {
    # each chunk as more, smaller bulk copies
    "copies8": [(re.escape("constexpr int FS_COPIES = 4;"), "constexpr int FS_COPIES = 8;")],
    "copies2": [(re.escape("constexpr int FS_COPIES = 4;"), "constexpr int FS_COPIES = 2;")],
    # barrier waits that spin (mbarrier.test_wait) instead of suspending
    # the thread until the phase completes (try_wait)
    "test_wait": [("tile_common.cuh", re.escape("mbarrier.try_wait.parity.shared::cta.b64"),
                   "mbarrier.test_wait.parity.shared::cta.b64")],
    # the weight stream's copies without the L2 evict-last hint
    "no_evict_last": [(re.escape("      const uint64_t policy = l2_evict_last();"),
                       "      uint64_t policy;\n      asm volatile(\"createpolicy.fractional."
                       "L2::evict_normal.b64 %0, 1.0;\\n\" : \"=l\"(policy));")],
    # a ring of 6 stages (16 KB of shared memory free for other use)
    "stages6": [(re.escape("constexpr int FS_STAGES = 7;"), "constexpr int FS_STAGES = 6;")],
}


def _esc(pattern, repl):
    return [(re.escape(pattern), repl)]


# Copies with one cost each taken out (their outputs wrong by design):
# name -> substitutions into this tree's fused_render.cu
ATTRIBUTION = {
    "no_narrow_heads": (
        _esc("if (lane < 16) sig = softplus(dot_row(trow, hw, W) + bs[B_SIG]);",
             "if (lane < 16) sig = 0.f;")
        + _esc("dot_rows<3>(h, trow, hw + W, HALF, HALF);", "h[0] = h[1] = h[2] = 0.f;")
        + _esc("dot_rows<2>(d, trow + HALF, hw + W + 3 * HALF, HALF, HALF);",
               "d[0] = d[1] = 0.f;")),
    "no_pe_sin": _esc("v = pe_value(c, ray_xb(ri, pj[i & 1], psc[i & 1], ri[6]));", "v = ri[6];"),
    "no_bias_loads": (
        _esc("b[j][0] = bias(h * NC + j * 8 + 2 * t);\n      b[j][1] = bias(h * NC + j * 8 + 2 * t + 1);",
             "b[j][0] = 0.f;\n      b[j][1] = 0.f;")
        + _esc("b[j][0] = bias(j * 8 + 2 * t);\n    b[j][1] = bias(j * 8 + 2 * t + 1);",
               "b[j][0] = 0.f;\n    b[j][1] = 0.f;")),
    # half of each chunk's bytes copied (the rest of the stage stale)
    "half_stream": (
        _esc("mbar_expect_tx(full + 8 * s, FS_CHUNK);", "mbar_expect_tx(full + 8 * s, FS_CHUNK / 2);")
        + _esc("for (int c = 0; c < FS_COPIES; ++c)", "for (int c = 0; c < FS_COPIES / 2; ++c)")),
}


def configs(names, reps=20, device=None, table=None):
    """{config: {"same_bits": {case: bool}, "ms": [...], "phases": {...}}}
    of copies of this tree with CONFIGS' substitutions, against this tree's
    build ("this") on the render chunk: each forward's outputs compared bit
    for bit, the four forwards timed in turns (this tree's build first),
    and each copy's phases from an instrumented copy of it."""
    dev = resolve_device(device)
    kw, calls = render_chunk(dev)
    builds = {"this": _build.SOURCE}
    phased = {}
    table = CONFIGS if table is None else table
    for name in names:
        builds[name] = source_copy(f"fwd_config_{name}", table[name])
        phased[name] = source_copy(f"fwd_config_{name}_phases", table[name],
                                   summed_phase_prelude("bench/stream_fwd.py", "FS", len(PHASES)))
    build_all(list(builds.values()) + list(phased.values()))
    outs = {}
    for tag, src in builds.items():
        with using(src):
            outs[tag] = {case: compared(op(kw, *args)) for case, (op, args) in calls.items()}

    def turn(_):
        return {case: time_ms(lambda op=op, args=args: op(kw, *args), reps, dev)
                for case, (op, args) in calls.items()}
    ms = in_turns(builds, turn)
    return {name: {"same_bits": {case: all(torch.equal(a, b) for a, b in
                                           zip(outs[name][case], outs["this"][case]))
                                 for case in calls},
                   "ms": ms[name], "this_ms": ms["this"],
                   "phases": phases(built=phased[name], device=dev)}
            for name in names}


# ---------------------------------------------------------------------------
# in turns against another build
# ---------------------------------------------------------------------------

def sweeps(device):
    """{name: render} of chip_smoke.py's 512x512 nadir sweeps with shadows
    in 4096-ray chunks: render (128 camera, 64 shadow samples),
    render_hier (96 + 48), both through the int8 trunk (render_q8,
    render_q8_hier) and render_diag (128 / 64 with ray entropy and the
    nadir diagnostics, through the per-point forwards); and the sweep's
    rays."""
    from eonerf_code_tpu_torch.config import TrainConfig
    from eonerf_code_tpu_torch.models.fused import make_render_field
    from eonerf_code_tpu_torch.render import satellite as sat

    field, rays_all = _field_and_sweep(device)
    fields = {"": make_render_field(field),
              "_q8": make_render_field(field, TrainConfig(trunk_quant="int8",
                                                          bwd_acts="recompute"))}
    cfgs = {"": sat.RenderConfig(n_samples=128, sc_n_samples=64),
            "_hier": sat.RenderConfig(n_samples=96, n_importance=48, sc_n_samples=64)}

    def render(f, cfg):
        with torch.no_grad():
            sat.render_image(f, rays_all, cfg, shadows=True, chunk=N_CHUNK,
                             generator=torch.Generator(device=device).manual_seed(2))
    out = {f"render{q}{h}": (lambda f=f, cfg=cfg: render(f, cfg))
           for q, f in fields.items() for h, cfg in cfgs.items()}
    # ray entropy and the nadir diagnostics: the per-point field forward
    # once a chunk and the density forward three times
    diag = sat.RenderConfig(n_samples=128, sc_n_samples=64, compute_entropy=True,
                            nadir_diagnostics=True)
    out["render_diag"] = lambda: render(fields[""], diag)
    return out, rays_all.origins.shape[0]


def turns(other, reps=20, device=None):
    """{build: [{case: ms}, ...]} of the four ray forwards at the render
    chunk's shapes and the point forwards on its points (POINT_CASES; CUDA
    events, the mean of `reps` calls) and of the five render sweeps
    (rays/s, the mean of 3), this tree's build and ``other``'s (a
    fused_render.cu) timed in turns (other, this, this, other)."""
    dev = resolve_device(device)
    kw, calls = render_chunk(dev)
    renders, n_rays = sweeps(dev)
    builds = {"other": Path(other), "this": _build.SOURCE}
    build_all(list(builds.values()))

    def turn(_):
        out = {name: time_ms(lambda op=op, args=args: op(kw, *args), reps, dev)
               for name, (op, args) in calls.items()}
        out.update({f"{name}_rays_per_s": n_rays / (time_ms(fn, 3, dev) * 1e-3)
                    for name, fn in renders.items()})
        return out
    return in_turns(builds, turn)


if __name__ == "__main__":
    name = card()
    cmd = sys.argv[1] if len(sys.argv) > 1 else "l2"
    if cmd == "l2":
        res = l2_rate()
        rate = res["gb_per_s"]["bulk"]
        parent = {f"{case}_k{k}": staged_traffic(rate, parent_tiles(N_CHUNK, kpad), camera)
                  for case, k, kpad, camera in (("camera", 127, 128, True),
                                                ("camera", 143, 144, True),
                                                ("shadow", 63, 64, False))}
        print(json.dumps({"l2_read": res, "earlier_design_weight_gb_ms": parent,
                          "ring_read": ring_rates(), "card": name}), flush=True)
    elif cmd == "phases":
        args = sys.argv[2:]
        other = args.pop(0) if args and args[0].endswith(".cu") else None
        groups = [[c for c in args if case_kind(c) == k] for k in ("ray", "save", "point")]
        if not args:
            groups = (PHASE_CASES, SAVE_CASES, POINT_CASES)
        for cases in groups:
            for case, res in (phases(other, cases=tuple(cases)) if cases else {}).items():
                print(json.dumps({"fwd_phases": case, **res, "card": name}), flush=True)
    elif cmd == "attribution":
        for config, res in configs(sys.argv[2:] or list(ATTRIBUTION), table=ATTRIBUTION).items():
            print(json.dumps({"fwd_attribution": config, **res, "card": name}), flush=True)
    elif cmd == "configs":
        for config, res in configs(sys.argv[2:] or list(CONFIGS)).items():
            print(json.dumps({"fwd_config": config, **res, "card": name}), flush=True)
    elif cmd == "turns":
        res = turns(sys.argv[2], *[int(a) for a in sys.argv[3:4]])
        print(json.dumps({"fwd_turns_ms": res, "card": name}), flush=True)
    else:
        raise SystemExit(__doc__)
