"""The int8 trunk alone on one CUDA card, at the shapes the main path gives
it: the render chunk's forwards (4096 rays: camera K=127 and 143, shadow
63, coarse 95; groups of the 2048-row target) and the training batch's
backward recomputes (1024 rays, camera K=127, shadow 63; the 1024-row
target, every activation to the stream).

    python -m eonerf_code_tpu_torch.bench.q8_trunk [reps]
    python -m eonerf_code_tpu_torch.bench.q8_trunk rings 3 4 6 ...
    python -m eonerf_code_tpu_torch.bench.q8_trunk attribution
    python -m eonerf_code_tpu_torch.bench.q8_trunk phases

One JSON line a shape: the path it takes and its cluster (CTAs, rows of a
group's last CTA, the clusters the card holds at once), the trunk's ms on
that path and on the layer-major one (CUDA events, the mean of `reps`
calls, default 10; both paths' stream columns and group amax compared bit
for bit), the whole int8 call's ms (the trunk and the heads; the
backward's dgrad, wgrad and reduction too), and the trunk's bound: the
int8 operations of its samples at 1,979 TOP/s against the bytes of rayin,
z and the stream columns it writes at 3.35 TB/s. Then the card's name and
power limit.

`rings` times the cluster kernel's weight ring instead: copies of csrc/
whose QSTAGES (64-byte chunks in the ring) differ, built
under _build/ (git-ignored) and each timed on the trunk alone at every
shape, in turns (the configurations in order, then in reverse), its
outputs against the first configuration's bit for bit. `attribution`
times copies with one cost each taken out (ATTRIBUTION: the cluster
exchange, the stream stores, the quantization, the products, the weight
copies, the PE's sin, the dequantization), whose outputs are wrong by
design. `phases` prints, for each shape, the clock cycles that one thread
of each group's first CTA spends between the kernel's landmarks (PHASES),
from another such copy.
"""

import concurrent.futures
import json
import re
import shutil
import subprocess
import sys

import torch

from eonerf_code_tpu_torch.bench.kernel_variants import (
    bench_rays,
    bench_weights,
    resolve_device,
    time_ms,
)
from eonerf_code_tpu_torch.ops import _build
from eonerf_code_tpu_torch.ops import fused_field as ff
from eonerf_code_tpu_torch.ops import fused_render as fr

PEAK_INT8_OPS = 1979e12   # H100 SXM, dense
PEAK_BYTES = 3.35e12
TRUNK_MACS = 256 * 64 + 6 * 256 * 256 + 256 * 320   # a sample's int8 multiply-adds

# name -> (rays, samples, group target, camera layout, every h to the stream)
SHAPES = {"camera_fwd": (4096, 127, 2048, True, False),
          "camera_fwd_k143": (4096, 143, 2048, True, False),
          "shadow_fwd": (4096, 63, 2048, False, False),
          "coarse_fwd": (4096, 95, 2048, False, False),
          "camera_bwd": (1024, 127, 1024, True, True),
          "shadow_bwd": (1024, 63, 1024, False, True)}


def trunk_bound_ms(r, k, rows, write_all):
    """(least ms, "operations" or "bytes") of the trunk over r rays of k
    samples padded to `rows` stream rows."""
    ops_ms = 2.0 * TRUNK_MACS * r * k / PEAK_INT8_OPS * 1e3
    cols = sum(b - a for a, b in fr.q8_stream_cols(write_all))
    bytes_ms = (r * fr.RAYIN_COLS * 4 + r * k * 4 + rows * cols * 2) / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def main(reps=10, device=None):
    dev = resolve_device(device)
    lib = _build.load_library()
    kw, _ = bench_weights(dev)
    q8 = ff.quantize_kernel_trunk(kw.mats.float())
    gen = torch.Generator(device=dev).manual_seed(3)
    results = []
    for name, (r, k, target, camera, write_all) in SHAPES.items():
        rayin, z, dm = bench_rays(r, k, gen, dev)
        kpad, rt, rp = fr.q8_plan(r, k, target)
        path, ctas, last = fr.q8_trunk_plan(kpad, rt * kpad)
        runs = [fr.q8_trunk(kw, q8, rayin, z, target, camera, write_all, p)
                for p in dict.fromkeys((path, "layer_major"))]
        same = all(torch.equal(a, runs[0][1]) and torch.equal(
            fr.q8_stream_written(s, write_all), fr.q8_stream_written(runs[0][0], write_all))
            for s, a in runs)
        del runs
        trunk = {p: time_ms(lambda: fr.q8_trunk(kw, q8, rayin, z, target, camera, write_all, p),
                            reps, dev) for p in dict.fromkeys((path, "layer_major"))}
        if write_all:
            g = torch.randn((r, fr.ACC_COLS) if camera else (r,), generator=gen, device=dev)
            args = (rayin, z, dm, g) if camera else (rayin, z, dm, torch.ones_like(z), g)
            call = fr.camera_backward_q8 if camera else fr.shadow_backward_q8
        else:
            args = (rayin, z, dm) if camera or name.startswith("coarse") else (
                rayin, z, dm, torch.ones_like(z))
            call = {"camera": fr.camera_forward_q8, "shadow": fr.shadow_forward_q8,
                    "coarse": fr.coarse_forward_q8}[name.split("_")[0]]
        call_ms = time_ms(lambda: call(kw, q8, *args), reps, dev)
        bound, bound_by = trunk_bound_ms(r, k, rp * kpad, write_all)
        res = {"name": name, "rays": r, "samples": k, "group_rows": rt * kpad, "path": path,
               "cluster_ctas": ctas, "last_cta_rows": last,
               "active_clusters": (lib.eonerf_q8_trunk_active_clusters(ctas)
                                   if path == "cluster" else None),
               "trunk_ms": trunk[path], "layer_major_ms": trunk["layer_major"],
               "call_ms": call_ms, "trunk_bound_ms": bound, "bound_by": bound_by,
               "same_bits_as_layer_major": same}
        print(json.dumps(res), flush=True)
        results.append(res)
    print(json.dumps({"active_clusters": {c: lib.eonerf_q8_trunk_active_clusters(c)
                                          for c in (16, 12, 9, 8, 4, 2)},
                      "sms": torch.cuda.get_device_properties(dev).multi_processor_count}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    if not all(res["same_bits_as_layer_major"] for res in results):
        raise AssertionError("the cluster path's bits differ from the layer-major path's")
    return results


def source_copy(tag, subs):
    """csrc/ copied under _build/q8_copies/<tag> with each (pattern,
    replacement) of `subs` made exactly once in fused_render.cu (a regular
    expression, its replacement literal text): the copy's
    fused_render.cu."""
    dst = _build.BUILD_DIR / "q8_copies" / tag
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.PACKAGE_DIR / "csrc", dst)
    src = dst / "fused_render.cu"
    text = src.read_text()
    for pattern, repl in subs:
        text, n = re.subn(pattern, lambda _, repl=repl: repl, text)   # repl taken literally
        if n != 1:
            raise RuntimeError(f"fused_render.cu matches {pattern!r} {n} times, not once")
    src.write_text(text)
    return src


def ring_copy(stages):
    return source_copy(f"ring{stages}", [(r"constexpr int QSTAGES = \d+;",
                                          f"constexpr int QSTAGES = {stages};")])


# Cost attribution: copies of the cluster kernel with one cost taken out
# (their outputs are wrong; only their times mean something).
ATTRIBUTION = {
    "no_exchange": [  # the group amax from the CTA's own rows: no DSMEM, no cluster barrier
        (r"cl\.map_shared_rank\(slots, tid\)\[rank\] = cm;", "slots[rank] = cm;"),
        (r"asm volatile\(\"barrier\.cluster\.arrive\.release\.aligned;\\n\" ::: \"memory\"\);",
         ""),
        (r"asm volatile\(\"barrier\.cluster\.wait\.acquire\.aligned;\\n\" ::: \"memory\"\);",
         "__syncthreads();")],
    "no_stream": [    # no bf16 activation to the stream
        (r"if \(write_all \|\| layer == 7\) \{\n      // the bf16 rows",
         "if (false) {\n      // the bf16 rows")],
    "no_quantize": [  # the next layer's int8 tile left as it is
        (r"    if \(active\) \{\n      int8_t\* q0", "    if (false) {\n      int8_t* q0")],
    "no_products": [  # no wgmma
        (r"        wgmma_s8_m64n128\(acc", "        if (kc < 0) wgmma_s8_m64n128(acc")],
    "no_weights": [   # no weight copies into the ring
        (r"      cp_async16\(dst \+ qunit", "      if (q < 0) cp_async16(dst + qunit")],
    "no_pe": [        # the PE lanes without their sin
        (r"v = pe_value\(c, __fadd_rn\(__fmul_rn\(os", "v = (__fadd_rn(__fmul_rn(os")],
    "no_dequant": [   # the accumulators left as they are (layers other than 5)
        (r"if \(layer != 5\) \{", "if (false) {")],
}


# Phase timing: a copy in which one thread (PHASE_THREAD, of warp 1) of
# each group's rank-0 CTA adds up clock64() cycles between the kernel's
# landmarks in shared memory (the staging tile's row padding), then writes
# them over its group's amax (so the copy's outputs are wrong by design).
PHASES = ("pe", "first_exchange", "products", "epilogue", "post_and_stream", "exchange_wait",
          "quantize")
PHASE_THREAD = 32
_T = "(*reinterpret_cast<long long*>(stg + {k} * LDS + 512))"


def _tick(k):
    return (f"if (rank == 0 && tid == {PHASE_THREAD}) {{ const long long tn = clock64(); "
            f"{_T.format(k=k)} += tn - tp_; tp_ = tn; }}\n")


PHASE_SUBS = [
    (r"  float\* gamax = amax \+ grp \* Q8P;\n",
     "  float* gamax = amax + grp * Q8P;\n  long long tp_ = clock64(); const long long t0_ = tp_;\n"
     f"  if (rank == 0 && tid == {PHASE_THREAD}) for (int k = 0; k < 8; ++k) {_T.format(k='k')}"
     " = 0;\n"),
    (r"  cluster_max_post\(m, wmax, slots, cl, rank, C\);\n  const float gm0",
     "  " + _tick(0) + "  cluster_max_post(m, wmax, slots, cl, rank, C);\n  const float gm0"),
    (r"  // the warp's 16 rows x 128 columns",
     "  " + _tick(1) + "  // the warp's 16 rows x 128 columns"),
    (r"    // the layer's per-column constants",
     "    " + _tick(6) + "    // the layer's per-column constants"),
    (r"    // the epilogue: pre = acc", "    " + _tick(2) + "    // the epilogue: pre = acc"),
    (r"    unsigned\* pslots = ", "    " + _tick(3) + "    unsigned* pslots = "),
    (r"    if \(layer == 7\) break;\n    const float gm",
     "    " + _tick(4) + "    if (layer == 7) break;\n    const float gm"),
    (r"    s_in = __fdiv_rn\(1\.f, inv\);\n", "    s_in = __fdiv_rn(1.f, inv);\n    " + _tick(5)),
    (r"  // the stream's last copies are done before",
     f"  if (rank == 0 && tid == {PHASE_THREAD}) {{ for (int k = 0; k < 7; ++k) gamax[k] = "
     f"(float){_T.format(k='k')}; gamax[7] = (float)(clock64() - t0_); }}\n"
     "  // the stream's last copies are done before"),
]


def phases(reps=3):
    """{shape: {phase: (mean, min, max) cycles over the groups' rank-0 CTAs,
    and their total}} from the instrumented copy (the last of `reps`
    runs)."""
    dev = resolve_device(None)
    src = source_copy("phases", PHASE_SUBS)
    _build.build(src)
    default = _build.SOURCE
    kw, _ = bench_weights(dev)
    q8 = ff.quantize_kernel_trunk(kw.mats.float())
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    try:
        _build.SOURCE = src
        _build.load_library.cache_clear()
        for name, (r, k, target, camera, write_all) in SHAPES.items():
            rayin, z, _ = bench_rays(r, k, gen, dev)
            for _ in range(reps):
                _, amax = fr.q8_trunk(kw, q8, rayin, z, target, camera, write_all)
            a = amax.double().cpu()
            out[name] = {p: (float(a[:, i].mean()), float(a[:, i].min()), float(a[:, i].max()))
                         for i, p in enumerate(PHASES + ("total",))}
            print(json.dumps({"phases": name, "cycles": out[name],
                              "device": torch.cuda.get_device_name(dev)}), flush=True)
    finally:
        _build.SOURCE = default
        _build.load_library.cache_clear()
    return out


def timed_copies(builds, reps):
    """{tag: [{shape: trunk ms}, ...]} of the cluster path of each copy's
    build, in turns (in order, then in reverse), and each copy's outputs
    against the first's bit for bit; the ptxas lines of the cluster
    kernel."""
    dev = resolve_device(None)
    kw, _ = bench_weights(dev)
    q8 = ff.quantize_kernel_trunk(kw.mats.float())
    gen = torch.Generator(device=dev).manual_seed(3)
    inputs = {name: bench_rays(r, k, gen, dev)[:2] for name, (r, k, *_) in SHAPES.items()}
    with concurrent.futures.ThreadPoolExecutor(8) as pool:   # every nvcc started together
        logs = dict(zip(builds, pool.map(lambda src: _build.build(src)[1], builds.values())))
    default = _build.SOURCE
    tags = list(builds)
    times = {c: [] for c in tags}
    same, first = {}, {}
    try:
        for c in tags + tags[::-1]:
            _build.SOURCE = builds[c]
            _build.load_library.cache_clear()
            turn = {}
            for name, (r, k, target, camera, write_all) in SHAPES.items():
                def fn():
                    return fr.q8_trunk(kw, q8, *inputs[name], target, camera, write_all)
                stream, amax = fn()
                out = (fr.q8_stream_written(stream, write_all), amax)
                del stream
                first.setdefault(name, out)
                same[c] = same.get(c, True) and all(torch.equal(a, b)
                                                    for a, b in zip(out, first[name]))
                del out
                turn[name] = time_ms(fn, reps, dev)
            times[c].append(turn)
    finally:
        _build.SOURCE = default
        _build.load_library.cache_clear()
    for c in tags:
        lines = logs[c].splitlines()
        at = [i for i, ln in enumerate(lines) if "q8_trunk_cluster" in ln and "Compiling" in ln]
        ptxas = [ln.strip() for i in at[:1] for ln in lines[i + 2:i + 4]]
        print(json.dumps({"build": c, "turns": times[c], "same_bits_as_first": same[c],
                          "ptxas": ptxas, "device": torch.cuda.get_device_name(dev)}), flush=True)
    return times, same


if __name__ == "__main__":
    if sys.argv[1:2] == ["rings"]:
        timed_copies({c: ring_copy(int(c)) for c in sys.argv[2:]}, 10)
    elif sys.argv[1:2] == ["phases"]:
        phases()
    elif sys.argv[1:2] == ["attribution"]:
        timed_copies({"as_is": source_copy("as_is", []),
                      **{tag: source_copy(tag, subs) for tag, subs in ATTRIBUTION.items()}}, 10)
    else:
        main(*(int(a) for a in sys.argv[1:2]))
