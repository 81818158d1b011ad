"""Two builds of the fused-render kernels on one card, in one process: the
checkout's csrc/fused_render.cu against another copy of it (a parent
commit's, unpacked with `git archive` into a git-ignored directory), on the
same inputs. Prints whether every output is the same bits, then each build's
kernel times in turns (other, this, this, other), so a change to the
kernels or to csrc/tile_common.cuh is compared on one card.

    python -m eonerf_code_tpu_torch.bench.ab_libraries OTHER/fused_render.cu

The other copy is built as it stands: headers are read beside it, so unpack
the whole csrc/ directory of the other tree.
"""

import sys
from pathlib import Path

import torch

from eonerf_code_tpu_torch.bench.kernel_variants import bench_weights, resolve_device, time_ms
from eonerf_code_tpu_torch.ops import _build
from eonerf_code_tpu_torch.ops import fused_field as ff
from eonerf_code_tpu_torch.ops import fused_render as fr


def cases(device):
    """name -> call of a kernel wrapper at a main-path shape: the camera
    forward at a render chunk (4096 x 127), the save forward and the
    backward at a training batch (1024 x 127), the density forward at the
    entropy probe (131,072 points), the field forward and backward."""
    kw, _ = bench_weights(device)
    gen = torch.Generator(device=device).manual_seed(3)

    def rays(r, k):
        o = torch.rand((r, 3), generator=gen, device=device) * 1.2 - 0.6
        o[:, 2] = 0.99
        d = torch.nn.functional.normalize(torch.tensor([0.02, 0.01, -1.0], device=device), dim=0)
        emb = torch.randn((r, 4), generator=gen, device=device)
        rayin = torch.cat([o, d.expand(r, 3), emb, torch.zeros((r, 6), device=device)], 1)
        z = torch.sort(torch.rand((r, k), generator=gen, device=device) * 2.0, dim=1)[0]
        dm = torch.diff(z, dim=1, append=torch.full((r, 1), 2.0, device=device))
        return rayin.contiguous(), z.contiguous(), dm.contiguous()

    render, batch = rays(4096, 127), rays(1024, 127)
    gacc = torch.randn((1024, fr.ACC_COLS), generator=gen, device=device)
    pos = torch.rand((131072, 3), generator=gen, device=device) * 2.0 - 1.0
    emb = torch.randn((131072, ff.EMB_DIM), generator=gen, device=device)
    g = torch.randn((16384, ff.FIELD_COLS), generator=gen, device=device)
    return {"camera_fwd": lambda: fr.camera_forward(kw, *render),
            "camera_fwd_save": lambda: fr.camera_forward_save(kw, *batch),
            "camera_bwd": lambda: fr.camera_backward(kw, *batch, gacc),
            "density_fwd": lambda: ff.density_forward(kw, pos),
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
    out = fn()
    if name == "camera_fwd_save" and out[1].is_cuda:   # the columns the forward writes
        out = (out[0], fr.stream_trunk_acts(out[1], True, 1024, 127))
    return [t.clone() for t in (out if isinstance(out, tuple) else (out,))]


def main(other, device=None, reps=20):
    """Returns ({case: same bits}, [(build, {case: ms})] in turns)."""
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
        same = {name: all(torch.equal(a, b) for a, b in zip(_outputs(name, fn), ref[name]))
                for name, fn in calls.items()}
        print("same bits:", same, flush=True)
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
