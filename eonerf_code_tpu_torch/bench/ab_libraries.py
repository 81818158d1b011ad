"""Two builds of the fused-render kernels on one card, in one process: the
checkout's csrc/fused_render.cu against another copy of it (a parent
commit's, unpacked with `git archive` into a git-ignored directory), on the
same inputs, one case for each production instantiation of the shared
products in csrc/tile_common.cuh and one for each int8 forward (the int8
trunk's launch). Prints whether every output is the same
bits (a save forward's: its per-ray output and its whole activation
stream, every row's columns 0..2111), the differing outputs of each case
where it is not (largest absolute difference and rel-L2 of each), then
each build's kernel times in turns (other, this, this, other), so a change
to the kernels or to csrc/tile_common.cuh is compared on one card.

    python -m eonerf_code_tpu_torch.bench.ab_libraries OTHER/fused_render.cu

The other copy is built as it stands: headers are read beside it, so unpack
the whole csrc/ directory of the other tree.
"""

import sys
from pathlib import Path

import torch

from eonerf_code_tpu_torch.bench.kernel_variants import (
    bench_rays,
    bench_weights,
    resolve_device,
    time_ms,
)
from eonerf_code_tpu_torch.bench.stream_fwd import (
    POINT_CASES,
    SAVE_CASES,
    compared,
    render_chunk,
)
from eonerf_code_tpu_torch.ops import _build
from eonerf_code_tpu_torch.ops import fused_field as ff
from eonerf_code_tpu_torch.ops import fused_render as fr


def cases(device):
    """name -> call of a kernel wrapper at a main-path shape, one a
    production instantiation of the shared products (gemm, dgemm): the
    camera forward at a render chunk (4096 x 127) and at the hierarchical
    K = 143, the shadow forward (4096 x 63) and the coarse one (4096 x 95);
    at a training batch (1024 rays) the save forwards (camera K=127 and
    143, shadow K=63), the camera and shadow backwards, the saved camera and
    shadow backwards (on the stream of the save forward that runs first),
    the int8 tier's camera backward (its bf16 dgrad) and
    the int8_full one (the heads-only dgrad); the density forward at the
    entropy probe (131,072 points), its backward (1024 x 63 points), the
    field forward and backward; and the int8 tier's forwards at the render
    shapes (camera 4096 x 127 and 143, shadow 4096 x 63, coarse 4096 x 95),
    each a launch of the int8 trunk (and the heads on gemm); and the
    forwards on a render chunk with its real cube masks
    (bench/stream_fwd.py render_chunk: camera K=127 and 143, shadow, coarse),
    where deltam is zero outside the cube, the save forwards on a training
    batch of its rays (SAVE_CASES, as ``<case>_cube``), and the field and
    density forwards on its points (POINT_CASES, as ``<case>_chunk``). The int8 calls
    take ``stats`` (:func:`_outputs` compares their group amax and, for the
    forwards, the stream columns the trunk wrote)."""
    kw, _ = bench_weights(device)
    q8 = ff.quantize_kernel_trunk(kw.mats.float())
    gen = torch.Generator(device=device).manual_seed(3)

    def rays(r, k):
        return bench_rays(r, k, gen, device)

    def shadow(r, k):
        rayin, z, dm = rays(r, k)
        return rayin, z, dm, torch.ones_like(z)

    render, render143, batch = rays(4096, 127), rays(4096, 143), rays(1024, 127)
    render_sh, batch_sh, coarse = shadow(4096, 63), shadow(1024, 63), rays(4096, 95)
    gacc = torch.randn((1024, fr.ACC_COLS), generator=gen, device=device)
    ggeo = torch.randn((1024,), generator=gen, device=device)
    pos = torch.rand((131072, 3), generator=gen, device=device) * 2.0 - 1.0
    emb = torch.randn((131072, ff.EMB_DIM), generator=gen, device=device)
    g = torch.randn((16384, ff.FIELD_COLS), generator=gen, device=device)
    g_sigma = torch.randn((1024 * 63,), generator=gen, device=device)
    batch143 = rays(1024, 143)
    saved = {}

    def stream(camera=True):   # the first build to run it makes the stream both builds read
        if camera not in saved:
            saved[camera] = (fr.camera_forward_save(kw, *batch) if camera
                             else fr.shadow_forward_save(kw, *batch_sh))[1]
        return saved[camera]

    # a render chunk with its real cube masks (a quarter of the shadow
    # samples in the cube; the streamed forwards skip the rest), and the
    # per-point forwards on its points
    kw_r, chunk = render_chunk(device)
    def cube_name(name):
        if name in POINT_CASES:
            return f"{name}_chunk"
        return f"{name}_cube" if name in SAVE_CASES else f"{name}_fwd_cube"
    cube = {cube_name(name): (lambda op=op, args=args: op(kw_r, *args))
            for name, (op, args) in chunk.items()}
    return {**cube, "camera_fwd": lambda: fr.camera_forward(kw, *render),
            "camera_fwd_k143": lambda: fr.camera_forward(kw, *render143),
            "shadow_fwd": lambda: fr.shadow_forward(kw, *render_sh),
            "coarse_fwd": lambda: fr.coarse_forward(kw, *coarse),
            "camera_fwd_save": lambda: fr.camera_forward_save(kw, *batch),
            "camera_fwd_save_k143": lambda: fr.camera_forward_save(kw, *batch143),
            "shadow_fwd_save": lambda: fr.shadow_forward_save(kw, *batch_sh),
            "camera_bwd": lambda: fr.camera_backward(kw, *batch, gacc),
            "camera_bwd_saved": lambda: fr.camera_backward_saved(kw, *batch, gacc, stream()),
            "shadow_bwd_saved": lambda: fr.shadow_backward_saved(kw, *batch_sh, ggeo,
                                                                 stream(False)),
            "shadow_bwd": lambda: fr.shadow_backward(kw, *batch_sh, ggeo),
            "camera_bwd_q8": lambda **st: fr.camera_backward_q8(kw, q8, *batch, gacc, **st),
            "camera_bwd_q8_full": lambda **st: fr.camera_backward_q8_full(kw, q8, *batch, gacc,
                                                                          **st),
            "camera_fwd_q8": lambda **st: fr.camera_forward_q8(kw, q8, *render, **st),
            "camera_fwd_q8_k143": lambda **st: fr.camera_forward_q8(kw, q8, *render143, **st),
            "shadow_fwd_q8": lambda **st: fr.shadow_forward_q8(kw, q8, *render_sh, **st),
            "coarse_fwd_q8": lambda **st: fr.coarse_forward_q8(kw, q8, *coarse, **st),
            "density_fwd": lambda: ff.density_forward(kw, pos),
            "density_bwd": lambda: ff.density_backward(kw, pos[:1024 * 63], g_sigma),
            "field_fwd": lambda: ff.field_forward(kw, pos, emb),
            "field_bwd": lambda: ff.field_backward(kw, pos[:16384], emb[:16384], g)}


def _use(source):
    """Make ``source``'s build the library every kernel wrapper loads, and
    check that it is the one loaded."""
    _build.SOURCE = Path(source)
    _build.load_library.cache_clear()
    path, _ = _build.build(source)
    loaded = _build.load_library()._name
    if Path(loaded) != path:
        raise RuntimeError(f"asked for the build of {source} ({path}), loaded {loaded}")
    return path.name


def _outputs(name, fn):
    stats = {}
    out = compared(fn(stats=stats) if "_q8" in name else fn())
    out += [stats[k].clone() for k in ("amax", "gamax") if k in stats]
    if "acts" in stats:     # an int8 forward's stream: the PE and h7
        out.append(fr.q8_stream_written(stats["acts"], False).clone())
    return out


def _compare(got, ref):
    """True where every output is the same bits, else {output index: (its
    largest absolute difference, its rel-L2 difference)} for the outputs
    that differ (NaN where their NaNs differ). A backward's outputs are (the
    matrix gradients, the bias gradients, d_rayin or d_pos[, d_emb]), then
    any stats."""
    if all(torch.equal(a, b) for a, b in zip(got, ref)):
        return True
    diff = {}
    for i, (a, b) in enumerate(zip(got, ref)):
        if torch.equal(a, b):
            continue
        a, b = a.double(), b.double()
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            diff[i] = (float("nan"), float("nan"))
            continue
        d = torch.nan_to_num(a - b)
        diff[i] = (float(d.abs().max()), float(d.norm() / torch.nan_to_num(b).norm()))
    return diff


def main(other, device=None, reps=20):
    """Returns ({case: True where every output is the same bits, else
    :func:`_compare`'s differences}, [(build, {case: ms})] in turns)."""
    dev = resolve_device(device)
    this = _build.SOURCE
    calls = cases(dev)
    try:
        libs = (_use(other), _use(this))
        if libs[0] == libs[1]:
            raise RuntimeError(f"both sources build the same library {libs[0]}")
        print("libraries: other", libs[0], "this", libs[1], flush=True)
        _use(other)
        ref = {name: _outputs(name, fn) for name, fn in calls.items()}
        _use(this)
        same = {name: _compare(_outputs(name, fn), ref[name]) for name, fn in calls.items()}
        print("same bits:", {name: s is True for name, s in same.items()}, flush=True)
        print("where not, {output: (largest abs difference, rel-L2)}:",
              {name: s for name, s in same.items() if s is not True}, flush=True)
        turns = []
        for label, src in (("other", other), ("this", this), ("this", this), ("other", other)):
            _use(src)
            turns.append((label, {name: time_ms(fn, reps, dev) for name, fn in calls.items()}))
            print(label, {k: round(v, 3) for k, v in turns[-1][1].items()}, flush=True)
    finally:
        _use(this)
    return same, turns


if __name__ == "__main__":
    main(sys.argv[1])
