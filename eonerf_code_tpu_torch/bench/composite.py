"""What the compositing epilogue costs on top of the density trunk, on the
card (the counterpart of the JAX package's scripts/proto_composite.py).

    python -m eonerf_code_tpu_torch.bench.composite [variant,...|all] [n]
        [tile] [--device cpu]

Variants on n points (default 1,040,384, cut to whole tiles) taken as rays
of 128 samples, 16 rays a 2048-row tile (the only tile it takes):
  base     - the density kernel: sigma (n, 1), the reference cost;
  reshape  - base + sdelta = sigma sd, T = exp(-exclusive cumsum of sdelta
             over the ray), w = T (1 - exp(-sdelta)): the row layout, a warp
             scanning a ray with shuffles;
  colscan  - the same function in the column layout: a shared-memory scan
             down the tile's column;
  accmm    - reshape's scan, then per ray sum_k w_k sigma_k into (n/128, 8).
One line per variant: ms per call, the mean of CUDA events over 10 launches
after one warm-up; on the card unless `--device cpu` (plain versions, host
ms).
"""

import sys

import torch

from eonerf_code_tpu_torch.bench import variants as vr
from eonerf_code_tpu_torch.bench.kernel_variants import bench_weights, resolve_device, time_ms


def composite_inputs(n, device):
    """The prototypes' weights and inputs on n points: (KernelWeights, pos
    (n, 3) uniform in [-1, 1), sd (n / 128, 128) uniform in [0, 0.1))."""
    kw, _ = bench_weights(device)
    gen = torch.Generator(device=device).manual_seed(1)
    pos = torch.rand((n, 3), generator=gen, device=device) * 2.0 - 1.0
    return kw, pos, torch.rand((n // vr.KPAD, vr.KPAD), generator=gen, device=device) * 0.1


def main(only="all", n=1040384, tile=2048, iters=10, device=None):
    """Time each variant; returns {variant: ms}."""
    dev = resolve_device(device)
    n = (n // tile) * tile
    kw, pos, sd = composite_inputs(n, dev)
    names = vr.COMPOSITES if only == "all" else tuple(only.split(","))
    unknown = sorted(set(names) - set(vr.COMPOSITES))
    if unknown:
        raise ValueError(f"unknown variants {unknown}; known: {', '.join(vr.COMPOSITES)}")
    results = {}
    for variant in names:
        ms = time_ms(lambda: vr.run_composite(variant, kw, pos, sd, tile), iters, dev)
        results[variant] = ms
        where = "on the CPU (plain version)" if dev.type == "cpu" else "(CUDA events)"
        print(f"{variant:8s}  {ms:9.3f} ms {where}", flush=True)
    return results


def parse(argv):
    """[variant,...|all] [n] [tile] [--device D] -> main's kwargs."""
    args, kwargs, it = [], {}, iter(argv)
    for a in it:
        if a == "--device":
            kwargs["device"] = next(it)
        else:
            args.append(a)
    if args and not args[0].isdigit():
        kwargs["only"] = args.pop(0)
    return dict(zip(("n", "tile"), map(int, args)), **kwargs)


if __name__ == "__main__":
    main(**parse(sys.argv[1:]))
