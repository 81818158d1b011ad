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
- :func:`workspace_streams`, :func:`wgrad_operands`, :func:`pack_wgrad`,
  :func:`wgrad_alone` (C entry ``eonerf_wgrad``): the streams a backward
  left in its workspace, and the pass alone on given streams, for tests.

On the card, the saved backwards at a training batch (1024 rays, camera
K=127, shadow K=63):

    python -m eonerf_code_tpu_torch.bench.backward_passes [iters]
"""

import ctypes
import json
import sys

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


def backward_pass_ms(weights, rayin, z, deltam, g, acts, mask=None, iters=10):
    """The saved camera backward (``mask`` None, ``g`` the (R, 8) gacc) or
    shadow backward (``g`` the (R,) ggeo) on the stream ``acts`` of its save
    forward, launch by launch on the card: each of the four timed alone with
    CUDA events over ``iters`` launches after a warm-up that fills what the
    next one reads, and the wgrad pass's library yardstick on the
    workspace's own streams. Returns {"ms": {pass: ms}, "library_wgrad_ms",
    "bound_ms": {pass: ms}, "bound_by": {pass: ...}, "wgrad_bytes",
    "wgrad_bytes_per_s"}. Measurement launches: not counted in the wrappers'
    ``launches``."""
    camera = mask is None
    dev = rayin.device
    if dev.type != "cuda":
        raise RuntimeError("backward_pass_ms times the kernels: CUDA tensors only")
    r, kpad = fr._check_call(weights, rayin, z, ("deltam", deltam, z.shape),
                             ("g", g, (z.shape[0], fr.ACC_COLS) if camera else (z.shape[0],)))
    fr._stream_for(camera, r, kpad, dev, acts)
    ws = fr._workspace(camera, r, kpad, dev, saved=True)
    grads = fr._zero_grads(r, dev)
    args = (rayin, fr._padded(z, kpad), fr._padded(deltam, kpad),
            None if camera else fr._padded(mask, kpad), g, weights.mats, weights.biases, acts, ws,
            *grads, r, kpad)
    ms = {}
    for p, name in enumerate(PASSES):
        ms[name] = _event_ms(lambda p=p: ff.launch("eonerf_bwd_pass", f"backward pass {p}", dev,
                                                   int(camera), p, *args), iters)
    lib_wgrad = wgrad_library(camera, *workspace_streams(ws, camera, r, kpad, acts))
    lay = stream_layout(camera, r, kpad, True)
    bounds, nbytes = pass_bounds(camera, r, kpad, lay)
    return {"ms": ms, "library_wgrad_ms": _event_ms(lib_wgrad, iters),
            "bound_ms": {p: b[0] for p, b in bounds.items()},
            "bound_by": {p: b[1] for p, b in bounds.items()},
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
    main(*[int(a) for a in sys.argv[1:2]])
