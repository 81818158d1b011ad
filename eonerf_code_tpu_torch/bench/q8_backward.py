"""int8_full's trunk backward alone on one CUDA card, at the training batch
(1024 rays: camera K=127, shadow K=63; scale groups of the 1024-row
target): the cotangent chain (q8_chain_cluster_kernel, one cluster launch a
call) and the weight gradient (q8_wgrad_kernel, every group summed in group
order in one launch).

    python -m eonerf_code_tpu_torch.bench.q8_backward [OTHER/fused_render.cu] [reps]
    python -m eonerf_code_tpu_torch.bench.q8_backward phases
    python -m eonerf_code_tpu_torch.bench.q8_backward partials
    python -m eonerf_code_tpu_torch.bench.q8_backward copies A/fused_render.cu B/fused_render.cu
    python -m eonerf_code_tpu_torch.bench.q8_backward attribution

One JSON line a shape: each pass's ms (CUDA events, the mean of `reps`
calls after a warm-up, default 10; C entry eonerf_q8_bwd_pass on a
workspace the whole call filled) beside its bound (the bytes it must move
at 3.35 TB/s against its int8 operations at 1,979 TOP/s) and its library
yardstick, a chain of PyTorch calls the port never makes: for the chain,
the same chain as torch calls with torch._int_mm for g8 w8^T
(`chain_library`); for the weight gradient, the products alone, one
torch._int_mm a layer over all rows (`wgrad_library`: not the same
function, it has no per-group scales). With OTHER (a parent's csrc/,
unpacked by `git archive` into a git-ignored directory), each build's
whole int8_full camera and shadow backwards in turns (other, this, this,
other) and, from a torch.profiler trace of each turn, the device ms of
the backward's int8 kernels by name. Then the card's name and power limit.

`phases` builds an instrumented copy of csrc/ (bench/csrc_copies.py: the
QC_* and QW_* landmarks defined, thread 0 of a CTA reading clock64()) and
prints the clock cycles a chain CTA and a weight-gradient tile spend in
each phase (CHAIN_PHASES, WGRAD_PHASES), summed over the layers and
chunks. The copy's bias (chain) and some weight (tile) gradients are the
phase sums, wrong by design. `partials` times the weight gradient against
the design it was chosen over, per-group partials summed in group order by
a second kernel (bench/q8_wgrad_partials.cu, appended to a copy of
csrc/fused_render.cu), in turns in one build, the two gradients compared
bit for bit. `copies` times builds of other copies of csrc/ (a design
variant each) pass by pass in turns, their outputs against the first's
bit for bit; `attribution` times copies with one cost taken out
(ATTRIBUTION: the cluster exchange, the masks, the stream stores, the
products; the weight gradient's products, quantizing, activation and g8
loads), whose outputs are wrong by design.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from eonerf_code_tpu_torch.bench import q8_trunk
from eonerf_code_tpu_torch.bench.csrc_copies import (
    build_all,
    in_turns,
    phase_prelude,
    source_copy,
    using,
)
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
TRUNK_MACS = 256 * 64 + 6 * 256 * 256 + 256 * 320   # a row's int8 multiply-adds
# name -> (rays, samples, group target, camera)
SHAPES = {"camera": (1024, 127, 1024, True), "shadow": (1024, 63, 1024, False)}
# the bytes a row moves: the chain reads g_h7 (256 bf16) and the 8 layers'
# activations (their masks, 256 bf16 each), writes g8 (8 x 256 int8) and
# the PE cotangent (64 bf16); the weight gradient reads the trunk's inputs
# (the PE and h0..h6, 64 + 7 x 256 bf16) and g8
CHAIN_ROW_BYTES = 256 * 2 + 8 * 256 * 2 + 8 * 256 + 64 * 2
WGRAD_ROW_BYTES = (64 + 7 * 256) * 2 + 8 * 256
_ACT_COL = [fr._act_col(i) for i in range(8)]


def bounds(rows, groups):
    """{pass: (least ms, "bytes" or "operations")} over `rows` stream rows
    in `groups` groups: the chain (weights: w8^T once), the weight gradient
    (its f32 output once), and the per-group partials' design (the partials
    written and read back too)."""
    w8 = ff.TRUNK_MAT_ELEMENTS
    ops_ms = 2.0 * TRUNK_MACS * rows / PEAK_INT8_OPS * 1e3
    out = {}
    for name, nbytes in (("chain", rows * CHAIN_ROW_BYTES + w8),
                         ("wgrad", rows * WGRAD_ROW_BYTES + w8 * 4),
                         ("wgrad_partials", rows * WGRAD_ROW_BYTES + w8 * 4
                          + 2 * groups * w8 * 4)):
        b = nbytes / PEAK_BYTES * 1e3
        out[name] = (max(b, ops_ms), "bytes" if b >= ops_ms else "operations")
    return out


def _case(dev, kw, q8, name, gen):
    r, k, target, camera = SHAPES[name]
    rayin, z, dm = bench_rays(r, k, gen, dev)
    mask = None if camera else torch.ones_like(z)
    g = torch.randn((r, fr.ACC_COLS) if camera else (r,), generator=gen, device=dev)
    args = (rayin, z, dm, g) if camera else (rayin, z, dm, mask, g)
    return args, fr.Q8BackwardCall(camera, True, kw, q8, rayin, z, dm, mask, g, target)


def chain_library(call, q8):
    """The cotangent chain as PyTorch calls on the call's own workspace
    (its g_h7 and activation stream): per layer the mask, the bias sums,
    the group amax, the quantization, torch._int_mm for g8 w8^T and the
    scaled bf16 rounding. A yardstick: the port never calls it."""
    lay = call.layout()
    rows, gr = call.rp * call.kpad, call.group_rows
    acts = call.act_stream()
    gh7 = call.ws[lay["gh"]:lay["gh"] + rows * 512].view(torch.bfloat16).view(rows, 256)
    w8, off = [], 0
    for n_in in (64, 256, 256, 256, 256, 320, 256, 256):
        w8.append(q8.w8[off:off + 256 * n_in].view(256, n_in))   # (out, in): g8 w8^T's B
        off += 256 * n_in
    sw = q8.scales.view(8, 256)

    def run():
        g, g_pe, sums = gh7.float(), None, []
        for i in range(7, -1, -1):
            g = torch.where(acts[:, _ACT_COL[i]:_ACT_COL[i] + 256] > 0, g, 0.0)
            sums.append(g.sum(dim=0))
            gs = g * sw[i]
            amax = gs.abs().view(-1, gr * 256).amax(dim=1).clamp(min=1e-12)
            inv = torch.full_like(amax, 127.0) / amax   # tensor / tensor: one rounding
            g8 = torch.round(gs * inv.repeat_interleave(gr)[:, None]).to(torch.int8)
            y = (torch._int_mm(g8, w8[i]).float()
                 * (torch.ones_like(inv) / inv).repeat_interleave(gr)[:, None]).to(torch.bfloat16)
            if i == 5:
                g, g_pe = y[:, :256].float(), y[:, 256:]
            elif i == 0:
                g_pe = (g_pe.float() + y.float()).to(torch.bfloat16)
            else:
                g = y.float()
        return g_pe, sums
    return run


def wgrad_library(call):
    """The weight gradient's products alone: one torch._int_mm a layer,
    inp8^T (in x rows) times g8 (rows x 256), over all rows at once. Not
    the same function (no per-group scales, int32 over every group): a
    yardstick of the int8 products' cost, which the port never calls."""
    rows, gr = call.rp * call.kpad, call.group_rows
    acts = call.act_stream()
    g8 = [x.contiguous() for x in fr.q8_g8_layers(call.g8_stream(), rows, gr)]
    pe = acts[:, fr._act_col(5) - 64:fr._act_col(5)]
    ins = [pe] + [acts[:, _ACT_COL[i]:_ACT_COL[i] + 256] for i in range(4)]
    ins += [torch.cat([acts[:, _ACT_COL[4]:_ACT_COL[4] + 256], pe], dim=1)]
    ins += [acts[:, _ACT_COL[i]:_ACT_COL[i] + 256] for i in (5, 6)]
    a8t = [torch.round(x.float().clamp(-1.0, 1.0) * 127.0).to(torch.int8).t().contiguous()
           for x in ins]

    def run():
        return [torch._int_mm(a, g) for a, g in zip(a8t, g8)]
    return run


def passes(reps=10, device=None):
    """{shape: ms of each pass and its bound and library yardstick} on this
    build."""
    dev = resolve_device(device)
    kw, _ = bench_weights(dev)
    q8 = ff.quantize_kernel_trunk(kw.mats.float())
    gen = torch.Generator(device=dev).manual_seed(3)
    lib = _build.load_library()
    out = {}
    for name in SHAPES:
        _, call = _case(dev, kw, q8, name, gen)
        call.run()
        rows, groups = call.rp * call.kpad, call.rp * call.kpad // call.group_rows
        plan = fr.q8_bwd_plan(call.kpad, call.group_rows)
        b = bounds(rows, groups)
        res = {"name": name, "rows": rows, "groups": groups, "path": plan["path"],
               "cluster_ctas": plan["ctas"],
               "active_clusters": lib.eonerf_q8_chain_active_clusters(plan["ctas"]),
               "call_ms": time_ms(call.run, reps, dev)}
        for label, p in (("chain", 1), ("wgrad", 2), ("reduce", 3), ("ray_grads", 4)):
            res[f"{label}_ms"] = time_ms(lambda p=p: call.run(p), reps, dev)
            if label in b:
                res[f"{label}_bound_ms"], res[f"{label}_bound_by"] = b[label]
        call.run()
        res["chain_library_ms"] = time_ms(chain_library(call, q8), reps, dev)
        res["wgrad_library_ms"] = time_ms(wgrad_library(call), reps, dev)
        res["device"] = torch.cuda.get_device_name(dev)
        print(json.dumps(res), flush=True)
        out[name] = res
        del call
        torch.cuda.empty_cache()
    return out


def _kernel_ms(fn, dev):
    """Device ms of each CUDA kernel (by name, templates stripped) of one
    call of fn, from a torch.profiler trace (after a warm-up call)."""
    fn()
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        if t and "q8_" in e.key:
            key = e.key.replace("(anonymous namespace)::", "").replace("void ", "")
            key = key.split("<")[0].split("(")[0].strip()
            out[key] = out.get(key, 0.0) + t / 1e3
    return out


def turns(other, reps=10, device=None):
    """The whole int8_full camera and shadow backwards of this build and of
    `other` in turns (other, this, this, other): CUDA-event ms and each
    int8 kernel's device ms."""
    dev = resolve_device(device)
    kw, _ = bench_weights(dev)
    q8 = ff.quantize_kernel_trunk(kw.mats.float())
    gen = torch.Generator(device=dev).manual_seed(3)
    inputs = {name: _case(dev, kw, q8, name, gen)[0] for name in SHAPES}
    ops = {"camera": fr.camera_backward_q8_full, "shadow": fr.shadow_backward_q8_full}

    def turn(label):
        out = {"build": label}
        for name, args in inputs.items():
            def fn(name=name, args=args):
                return ops[name](kw, q8, *args)
            out[f"{name}_ms"] = time_ms(fn, reps, dev)
            out[f"{name}_kernels_ms"] = _kernel_ms(fn, dev)
        print(json.dumps(out), flush=True)
        return out
    # parent, this, this, parent
    return in_turns({"other": Path(other), "this": _build.SOURCE}, turn)


# Phase timing: the copy defines the landmarks that the production source
# leaves empty (bench/csrc_copies.py's phase_prelude): QC_* for a chain CTA,
# whose totals go over its row of bias partial sums, which the reduction
# then sums over the CTAs; QW_* for a weight-gradient tile, over the tile's
# first gradients.
CHAIN_PHASES = ("g_h7_and_first_mask", "mask_colsums_max", "exchange_and_fold", "quantize",
                "ring_wait", "products", "g8_stores", "epilogue")
WGRAD_PHASES = ("ring_wait", "quantize_transpose", "products", "group_epilogue")
PHASE_PRELUDE = phase_prelude("bench/q8_backward.py", {"QC": CHAIN_PHASES, "QW": WGRAD_PHASES})


def phases(reps=3, device=None):
    """{shape: {"chain": {phase: cycles a CTA}, "wgrad": {phase: cycles a
    tile}}} from the instrumented copy (the last of `reps` calls)."""
    dev = resolve_device(device)
    src = source_copy("q8_bwd_phases", prelude=PHASE_PRELUDE)
    _build.build(src)
    kw, _ = bench_weights(dev)
    q8 = ff.quantize_kernel_trunk(kw.mats.float())
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    tiles = fr.q8_wgrad_tiles()
    offs = [0]
    for n_in in fr._TRUNK_IN:
        offs.append(offs[-1] + 256 * n_in)
    with using(src):
        for name in SHAPES:
            _, call = _case(dev, kw, q8, name, gen)
            for _ in range(reps):
                call.run()
            torch.cuda.synchronize(dev)
            ctas = call.layout()["bias_rows"]
            dbias, dmats = call.grads[1].double().cpu(), call.grads[0].double().cpu()
            chain = {p: float(dbias[i]) / ctas for i, p in enumerate(CHAIN_PHASES)}
            chain["total"] = sum(chain.values())
            wg = {p: 0.0 for p in WGRAD_PHASES}
            for layer, m0, n0 in tiles:
                at = offs[layer] + n0 * fr._TRUNK_IN[layer] + m0
                for i, p in enumerate(WGRAD_PHASES):
                    wg[p] += float(dmats[at + i]) / len(tiles)
            wg["total"] = sum(wg.values())
            out[name] = {"chain": chain, "wgrad": wg}
            print(json.dumps({"phases": name, "chain_cycles_a_cta": chain,
                              "wgrad_cycles_a_tile": wg, "ctas": ctas, "tiles": len(tiles),
                              "device": torch.cuda.get_device_name(dev)}), flush=True)
            del call
    return out


PARTIALS_SOURCE = Path(__file__).with_name("q8_wgrad_partials.cu")


def partials(reps=10, device=None):
    """{shape: {"wgrad": [ms a turn], "partials": [ms a turn], "same_bits":
    bool}}: q8_wgrad_kernel (pass 2) against the per-group partials and
    their reduction (bench/q8_wgrad_partials.cu) on the same workspace, in
    turns (wgrad, partials, partials, wgrad) in one build of this tree's
    csrc/ with that file appended, and their weight gradients bit for bit."""
    dev = resolve_device(device)
    src = source_copy("q8_bwd_partials")
    src.write_text(src.read_text() + PARTIALS_SOURCE.read_text())
    _build.build(src)
    kw, _ = bench_weights(dev)
    q8 = ff.quantize_kernel_trunk(kw.mats.float())
    gen = torch.Generator(device=dev).manual_seed(3)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    out = {}
    with using(src):
        _build.load_library().eonerf_q8_wgrad_partials.argtypes = [i] + [p] * 6 + [i, i, ll, p, i]
        for name in SHAPES:
            _, call = _case(dev, kw, q8, name, gen)
            groups = call.rp * call.kpad // call.group_rows
            qwpart = torch.empty((groups * ff.TRUNK_MAT_ELEMENTS,), dtype=torch.float32,
                                 device=dev)
            dmats = call.grads[0]

            def run_partials():
                ff.launch("eonerf_q8_wgrad_partials", "q8 wgrad partials", dev,
                          int(call.camera), call.ws, q8.scales, call.amax, call.gamax, dmats,
                          qwpart, call.rp, call.kpad, call.group_rows, after_stream=(call.path,))
            call.run()
            want = dmats[:ff.TRUNK_MAT_ELEMENTS].clone()
            dmats.zero_()
            run_partials()
            res = {"same_bits": bool(torch.equal(dmats[:ff.TRUNK_MAT_ELEMENTS], want)),
                   "wgrad": [], "partials": []}
            for label in ("wgrad", "partials", "partials", "wgrad"):
                fn = run_partials if label == "partials" else (lambda: call.run(2))
                res[label].append(time_ms(fn, reps, dev))
            rows = call.rp * call.kpad
            res["bound_ms"] = {k: v[0] for k, v in bounds(rows, groups).items()
                               if k.startswith("wgrad")}
            print(json.dumps({"partials": name, **res,
                              "device": torch.cuda.get_device_name(dev)}), flush=True)
            out[name] = res
            del call, qwpart
            torch.cuda.empty_cache()
    return out


def copies(sources, reps=10, device=None, check_bits=True):
    """Builds of other copies of this tree's csrc/ (``sources``: their
    fused_render.cu, e.g. a design variant under a git-ignored directory)
    timed pass by pass in turns (in order, then in reverse) at both shapes,
    every build's outputs against the first's bit for bit: {source:
    [{shape: {pass: ms}}, ...]}."""
    dev = resolve_device(device)
    kw, _ = bench_weights(dev)
    q8 = ff.quantize_kernel_trunk(kw.mats.float())
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = {name: _case(dev, kw, q8, name, gen)[0] for name in SHAPES}
    first, same = {}, {}

    def turn(src):
        out = {}
        for name, args in cases.items():
            r, k, target, camera = SHAPES[name]
            mask = args[3] if not camera else None
            call = fr.Q8BackwardCall(camera, True, kw, q8, *args[:3], mask, args[-1], target)
            call.run()
            got = [t.clone() for t in call.grads] + [call.gamax.clone()]
            first.setdefault(name, got)
            same[src] = same.get(src, True) and all(
                torch.equal(a, b) for a, b in zip(got, first[name]))
            out[name] = {label: time_ms(lambda p=p: call.run(p), reps, dev)
                         for label, p in (("chain", 1), ("wgrad", 2))}
            del call
        return out
    times = in_turns({str(src): src for src in sources}, turn)
    for src in times:
        print(json.dumps({"build": src, "turns": times[src],
                          "same_bits_as_first": same[src] if check_bits else None,
                          "device": torch.cuda.get_device_name(dev)}), flush=True)
    return times, same


# Cost attribution: copies of csrc/ with one cost taken out of the chain or
# the weight gradient (their outputs are wrong; only their times mean
# something), timed by `copies` in turns against the source as it is.
ATTRIBUTION = {
    "no_exchange": q8_trunk.ATTRIBUTION["no_exchange"],   # the amax from the CTA's own rows
    "chain_no_masks": [        # the next layer's activations never staged
        (r"    if \(layer > 0\) stage_mask\(layer - 1\);",
         "    if (false) stage_mask(layer - 1);")],
    "chain_no_stream": [       # no g8 to the stream
        (r"          if \(16 \* k < nrows\)\n            \*reinterpret_cast<uint4\*>\(g8c",
         "          if (false)\n            *reinterpret_cast<uint4*>(g8c")],
    "chain_no_products": [     # no wgmma on the h columns
        (r"            wgmma_s8_m64n128\(acc, a\[0\], qdesc\(st \+ c0 \* QKC\)\);\n"
         r"            wgmma_s8_m64n128\(acc, a\[1\], qdesc\(st \+ c0 \* QKC \+ 32\)\);",
         "            if (kc < 0) {\n            wgmma_s8_m64n128(acc, a[0], qdesc(st + c0 * QKC));\n"
         "            wgmma_s8_m64n128(acc, a[1], qdesc(st + c0 * QKC + 32)); }")],
    "wgrad_no_products": [     # no wgmma
        (r"        wgmma_s8_ss_m64n64\(acc, G::desc\(sa, k\)",
         "        if (k < 0) wgmma_s8_ss_m64n64(acc, G::desc(sa, k)")],
    "wgrad_no_quantize": [     # only the first chunk quantized
        (r"    if \(qi \+ 1 < total\) quantize\(qi \+ 1\);",
         "    if (qi + 1 < 0) quantize(qi + 1);")],
    "wgrad_no_act_loads": [    # the activations' rows never staged
        (r"      cp_async16_zfill\(dst \+ r \* \(QW_T \* 2\)",
         "      if (s < 0) cp_async16_zfill(dst + r * (QW_T * 2)")],
    "wgrad_no_g8_loads": [     # g8 never staged
        (r"      cp_async16\(dst \+ G::A_BYTES \+ G::at\(n, 16 \* u\),",
         "      if (s < 0) cp_async16(dst + G::A_BYTES + G::at(n, 16 * u),")],
}


def attribution(reps=10):
    """Each ATTRIBUTION copy's passes against the source as it is, in turns
    (:func:`copies`); the copies are built together."""
    builds = [source_copy("q8_bwd_as_is")]
    builds += [source_copy(f"q8_bwd_{tag}", subs) for tag, subs in ATTRIBUTION.items()]
    build_all(builds)
    return copies(builds, reps, check_bits=False)


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


if __name__ == "__main__":
    if sys.argv[1:2] == ["phases"]:
        phases()
    elif sys.argv[1:2] == ["partials"]:
        partials()
    elif sys.argv[1:2] == ["copies"]:
        copies(sys.argv[2:])
    elif sys.argv[1:2] == ["attribution"]:
        attribution()
    else:
        rest = sys.argv[1:]
        other = rest.pop(0) if rest and rest[0].endswith(".cu") else None
        reps = int(rest[0]) if rest else 10
        passes(reps)
        if other:
            turns(other, reps)
    print(card_line(), flush=True)
