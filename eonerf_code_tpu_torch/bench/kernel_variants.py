"""Intra-kernel cost attribution for the field kernel on the card: times the
stripped-down variants of bench/variants.py, each removing one cost from
the production forward, and the slab chains that measure the tile design's
ceiling (the counterpart of the JAX package's
scripts/bench_kernel_variants.py).

    python -m eonerf_code_tpu_torch.bench.kernel_variants [n] [tile] [iters]
        [variant,...] [--device cpu]

n points (default 1,040,384, cut to whole tiles), TPU grid tiles of `tile`
rows (2048; the slab chains seed each tile, or its halves or quarters, from
its first point), `iters` timed calls after one warm-up (10). Variants:
full, trunk, nope, norelu, nocast, mm_only (the default six), mm_int2,
mm_int4, mm_i8, mm_i8_dyn, mm_f8, mm_k512, mm_i8_k512, mm_merged2,
mm_merged4, mm_seq2, trunk_int2, mm_fwd_save, mm_bwd_rec, mm_bwd_saved.

One line per variant: ms per call (the mean of CUDA events over `iters`
launches), the rate from the work the variant needs (TFLOP/s, TOP/s for the
int8 chains) and its share of the H100 SXM's dense peak (bf16 989.4 TFLOP/s,
int8 and fp8 1,978.9). On the card unless `--device cpu`, where the plain
versions run and the line gives the host's ms only.

Decision rule of the backward slabs: saving activations pays iff
t(mm_fwd_save) + t(mm_bwd_saved) < t(mm_only) + t(mm_bwd_rec).
"""

import sys
import time

import torch

from eonerf_code_tpu_torch.bench import variants as vr
from eonerf_code_tpu_torch.models.eonerf import EONerfField
from eonerf_code_tpu_torch.ops import fused_field as ff

N_IMAGES = 10


def time_ms(fn, iters, device):
    """Mean ms of `iters` calls of fn after one warm-up: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    if device.type == "cpu":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def resolve_device(device):
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench's kernels run only on the card "
                           "(pass device='cpu' for the plain versions)")
    return dev


def bench_weights(device, seed=0):
    """The bench's EONerfField(n_images=10) at the published 8x256 widths,
    seeded from an explicit generator, packed as the kernels read it."""
    field = EONerfField(N_IMAGES, compute_dtype=torch.bfloat16, device=device,
                        generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        kw = ff.pack_kernel_weights(ff.pack_params(field), torch.bfloat16)
    return kw, vr.slab_weights(kw)


def bench_inputs(n, device, with_acts=True):
    """The bench's weights and inputs on n points: (KernelWeights,
    SlabWeights, pos (n, 3) uniform in [-1, 1), emb (n, 4) normal, acts
    (n, 2048) normal bf16 for mm_bwd_saved, or None), from fixed seeds."""
    kw, sw = bench_weights(device)
    gen = torch.Generator(device=device).manual_seed(1)
    pos = torch.rand((n, 3), generator=gen, device=device) * 2.0 - 1.0
    emb = torch.randn((n, 4), generator=gen, device=device)
    acts = None
    if with_acts:
        acts = torch.randn((n, vr.ACTS_COLS), generator=gen, device=device).to(torch.bfloat16)
    return kw, sw, pos, emb, acts


def slab_split_ms(sw, pos, acts, tile, iters):
    """mm_bwd_saved's passes timed one by one on the card, beside their
    library chains and bounds: {slab_dgrad, slab_wgrad, reduce,
    library_dgrad, library_wgrad: ms, bound_ms: {pass: ms}, bound_by:
    {pass: ...}, slab_wgrad_bytes_per_s: the bytes slab_wgrad must move over
    its time}."""
    split = vr.slab_pass_ms(sw, pos, acts, tile, iters)
    dgrad, wgrad = vr.library_slab_passes(sw, pos, acts, tile)
    split.update(library_dgrad=time_ms(dgrad, iters, pos.device),
                 library_wgrad=time_ms(wgrad, iters, pos.device))
    bounds = vr.slab_pass_bounds(pos.shape[0])
    wgrad_bytes = bounds.pop("slab_wgrad_bytes")
    split.update(bound_ms={p: b[0] for p, b in bounds.items()},
                 bound_by={p: b[1] for p, b in bounds.items()},
                 slab_wgrad_bytes_per_s=wgrad_bytes / (split["slab_wgrad"] * 1e-3))
    return split


def report(variant, tile, n, ms, device):
    """The variant's line: ms, and on the card its rate and share of peak."""
    if device.type == "cpu":
        return f"{variant:12s} tile={tile}  {ms:9.3f} ms on the CPU (plain version)"
    top, unit = vr.peak(variant)
    rate = vr.flops(variant, n) / (ms * 1e-3)
    return (f"{variant:12s} tile={tile}  {ms:9.3f} ms  {rate / 1e12:7.1f} {unit}  "
            f"({100 * rate / top:5.1f}% of the H100 SXM peak)")


def main(n=1040384, tile=2048, iters=10, only=None, device=None):
    """Time each variant; returns {variant: ms}."""
    dev = resolve_device(device)
    n = (n // tile) * tile
    names = only.split(",") if only else vr.DEFAULT_VARIANTS
    unknown = sorted(set(names) - set(vr.VARIANTS))
    if unknown:
        raise ValueError(f"unknown variants {unknown}; known: {', '.join(vr.VARIANTS)}")
    kw, sw, pos, emb, acts = bench_inputs(n, dev, "mm_bwd_saved" in names)
    results = {}
    for variant in names:
        ms = time_ms(lambda: vr.run(variant, kw, sw, pos, emb, acts, tile), iters, dev)
        results[variant] = ms
        print(report(variant, tile, n, ms, dev), flush=True)
        if variant == "mm_bwd_saved" and dev.type == "cuda":
            split = slab_split_ms(sw, pos, acts, tile, iters)
            print("  " + "  ".join(f"{k} {split[k]:.3f} ms" for k in (
                "slab_dgrad", "slab_wgrad", "reduce", "library_dgrad", "library_wgrad")), flush=True)
            print("  bounds " + "  ".join(f"{k} {v:.3f} ms ({split['bound_by'][k]})"
                                          for k, v in split["bound_ms"].items())
                  + f"  slab_wgrad {split['slab_wgrad_bytes_per_s'] / 1e12:.2f} TB/s", flush=True)
    decision = {"mm_only", "mm_fwd_save", "mm_bwd_rec", "mm_bwd_saved"}
    if dev.type == "cuda" and decision <= set(results):
        saved = results["mm_fwd_save"] + results["mm_bwd_saved"]
        rec = results["mm_only"] + results["mm_bwd_rec"]
        print(f"decision: saved {saved:.3f} ms vs recompute {rec:.3f} ms -> "
              f"{'save' if saved < rec else 'recompute'}", flush=True)
    return results


def parse(argv):
    """[n] [tile] [iters] [variant,...] [--device D] -> main's kwargs."""
    ints, kwargs, it = [], {}, iter(argv)
    for a in it:
        if a == "--device":
            kwargs["device"] = next(it)
        elif a.isdigit():
            ints.append(int(a))
        else:
            kwargs["only"] = a
    return dict(zip(("n", "tile", "iters"), ints), **kwargs)


if __name__ == "__main__":
    main(**parse(sys.argv[1:]))
