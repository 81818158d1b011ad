"""The weight-gradient product's ring configurations on one card: copies of
csrc/ whose wgemm ring (tile_common.cuh: WKC samples a chunk, WSTAGES
chunks) differs, each built and timed on the three passes that run on it,
in turns (the configurations in order, then in reverse).

    python -m eonerf_code_tpu_torch.bench.wgrad_rings 32:4 64:3 ...

For each WKC:WSTAGES, one JSON line: the saved camera and shadow
backwards' wgrad pass (bench/backward_passes.py, 1024 rays, K=127 / 63) and
mm_bwd_saved's slab_wgrad (bench/variants.py, 1,040,384 rows), ms in each
turn, and whether the camera backward's weight gradients are the same bits
as the first configuration's. The copies are built under _build/ (git
ignored), which the build hashes by content.
"""

import concurrent.futures
import json
import re
import shutil
import sys

import torch

from eonerf_code_tpu_torch.bench import backward_passes as bp
from eonerf_code_tpu_torch.bench import kernel_variants as kv
from eonerf_code_tpu_torch.bench import variants as vr
from eonerf_code_tpu_torch.ops import _build
from eonerf_code_tpu_torch.ops import fused_render as fr


def ring_copy(wkc, stages):
    """csrc/ copied with the ring's two constants set: the copy's
    fused_render.cu and kernel_variants.cu paths."""
    src = _build.PACKAGE_DIR / "csrc"
    dst = _build.BUILD_DIR / "rings" / f"{wkc}x{stages}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    header = dst / "tile_common.cuh"
    text = header.read_text()
    for name, value in (("WKC", wkc), ("WSTAGES", stages)):
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                          text)
        if n != 1:
            raise RuntimeError(f"tile_common.cuh has no single {name} constant")
    header.write_text(text)
    return dst / "fused_render.cu", dst / "kernel_variants.cu"


def _use(render, variants):
    _build.SOURCE, _build.VARIANTS_SOURCE = render, variants
    _build.load_library.cache_clear()
    _build.load_variants_library.cache_clear()


def main(configs, iters=10):
    dev = torch.device("cuda")
    kw, sw, pos, _, acts_v = kv.bench_inputs(1040384, dev)
    cam, gacc, sh, ggeo = bp.training_batch(dev)
    builds = {}
    for c in configs:
        wkc, stages = (int(x) for x in c.split(":"))
        builds[c] = ring_copy(wkc, stages)
    with concurrent.futures.ThreadPoolExecutor(8) as pool:   # every nvcc started together
        list(pool.map(_build.build, [src for pair in builds.values() for src in pair]))
    default = (_build.SOURCE, _build.VARIANTS_SOURCE)
    times = {c: [] for c in configs}
    same = {}
    try:
        first = None
        for c in list(configs) + list(reversed(configs)):
            _use(*builds[c])
            acts = fr.camera_forward_save(kw, *cam)[1]
            grads = fr.camera_backward_saved(kw, *cam, gacc, acts)[0]
            first = grads if first is None else first
            same[c] = bool(torch.equal(grads, first))
            acts_sh = fr.shadow_forward_save(kw, *sh)[1]
            times[c].append({
                "camera_wgrad": bp.backward_pass_ms(kw, *cam, gacc, acts, None, iters)["ms"]["wgrad"],
                "shadow_wgrad": bp.backward_pass_ms(kw, *sh[:3], ggeo, acts_sh, sh[3],
                                                    iters)["ms"]["wgrad"],
                "slab_wgrad": vr.slab_pass_ms(sw, pos, acts_v, 2048, iters)["slab_wgrad"]})
            del acts, acts_sh
    finally:
        _use(*default)
    for c in configs:
        print(json.dumps({"ring": c, "turns": times[c], "same_bits_as_first": same[c],
                          "device": torch.cuda.get_device_name(dev)}), flush=True)
    return times, same


if __name__ == "__main__":
    main(sys.argv[1:])
