#!/usr/bin/env python3
"""Drive the PyTorch port's render-and-DSM path once on one CUDA card.

    python3 chip_smoke.py

Phases (one JSON line each; any failure raises and exits non-zero):

1. build   - nvcc builds the fused-render kernels from the checkout
             (eonerf_code_tpu_torch/csrc/fused_render.cu) into the
             git-ignored eonerf_code_tpu_torch/_build/.
2. kernels - the camera and shadow kernels against their plain PyTorch
             versions at the main path's shapes (4096 rays; camera K=127,
             shadow K=63; full 8x256 bf16 field): errors, kernel / plain /
             bound times.
3. render  - a full-width EONerfField (20 images, seeded init, bf16) behind
             make_render_field renders a 512x512 orthographic nadir sweep
             with shadows in 4096-ray chunks. All 13 outputs must have their
             shapes and be finite, each kernel must have launched once per
             chunk, and a 1024-ray subset must agree with the per-sample
             (non-kernel) path.
4. dsm     - the rendered depth is rasterised to a DSM on the card, and
             device_dsm_mae must recover a known shift and z-bias applied
             to a copy of it. The field is untrained: this checks the
             machinery, not quality.

Then the kernels summary line, the card's name and power limit as
nvidia-smi reports them, and last {"ok": true, "device": {...}}.
Exits non-zero without printing results when no CUDA device is present.
"""

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
N_CHUNK = 4096
# H100 SXM dense peaks (NVIDIA data sheet, at the 700 W power limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# Kernel vs plain version: both round to bf16 at the same points, but the
# f32 sums run in another order (tensor-core fragments vs cuBLAS), so a
# bf16 rounding (2^-8 relative) can flip and travel through the trunk.
# Outputs are of order 1 (depth in [0, 2], albedo/t_s in [0, 1], geo in
# [0, 1]).
KERNEL_TOL = {"max_abs": 2e-2, "mean_abs": 2e-3}
# Kernel path vs the per-sample module path on a 1024-ray subset: the
# per-sample path rounds the way flax does (bf16 bias add, bf16 head
# outputs), the kernels keep f32 bias adds and f32 heads, so roundings
# differ at every layer; held on the mean over rays.
PATH_TOL = {"depth_mean_abs": 2e-2, "rgb_mean_abs": 2e-2}
DSM_SHIFT = (3, -2)        # (dx, dy) in cells
DSM_ZBIAS = 1.5            # metres


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def tpu_kernel_site(fn_name):
    """file:line of a Pallas kernel body in the JAX reference package that
    sits beside the port (read as text, never imported)."""
    for path in sorted(ROOT.glob("*/ops/pallas/fused_render.py")):
        if path.parts[-4] == "eonerf_code_tpu_torch":
            continue
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if line.startswith(f"def {fn_name}("):
                return f"{path.relative_to(ROOT)}:{i}"
    raise FileNotFoundError(f"Pallas kernel {fn_name} not found")


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1

    from eonerf_code_tpu_torch.data.rays import satrays_from_tensor
    from eonerf_code_tpu_torch.eval.device import device_dsm_mae
    from eonerf_code_tpu_torch.models.eonerf import EONerfField
    from eonerf_code_tpu_torch.models.fused import KernelField, make_render_field
    from eonerf_code_tpu_torch.ops import _build
    from eonerf_code_tpu_torch.ops import fused_render as fr
    from eonerf_code_tpu_torch.ops.fused_field import (
        density_subset,
        flatten_weights,
        is_bias,
        pack_params,
    )
    from eonerf_code_tpu_torch.ops.raster import rasterize_pointcloud
    from eonerf_code_tpu_torch.ops.sampling import set_last_valid
    from eonerf_code_tpu_torch.render import satellite as sat
    from eonerf_code_tpu_torch.render.nadir import nadir_rays_with_sun

    # the plain versions' float32 products must not drop to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()

    # ---- 1. build ----
    t0 = time.perf_counter()
    lib_path, log = _build.build()
    _build.load_library()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "library": lib_path.name,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln],
          "card": card})

    # ---- 2. kernels against their plain versions at main-path shapes ----
    field = EONerfField(20, compute_dtype=torch.bfloat16, device=dev,
                        generator=torch.Generator().manual_seed(0))
    rf = make_render_field(field)
    if not isinstance(rf, KernelField):
        raise RuntimeError("make_render_field did not pick the kernels for a bf16 8x256 field")
    kw = rf.pack()
    cfg = sat.RenderConfig(n_samples=128, sc_n_samples=64)
    scene_scale = np.array([256.0, 256.0, 60.0])
    rays_np, h, w = nadir_rays_with_sun(512, 512, 35.0, 140.0, scene_scale)
    rays_all = satrays_from_tensor(torch.from_numpy(rays_np).to(dev),
                                   torch.zeros(rays_np.shape[0], dtype=torch.long, device=dev))
    gen = torch.Generator(device=dev).manual_seed(1)
    mid = rays_np.shape[0] // 2     # a chunk from the middle of the image, away from its edge
    sub = sat.SatRays(*(x[mid:mid + N_CHUNK] for x in rays_all))
    z_mid, delta, _, mask = sat._camera_samples(sub.origins, sub.viewdirs, sub.t_near, cfg, gen)
    deltam = (set_last_valid(delta, mask, cfg.inf_delta) * mask).contiguous()
    emb = torch.randn((N_CHUNK, 4), generator=gen, device=dev)
    rayin = torch.cat([sub.origins, sub.viewdirs, emb,
                       torch.zeros((N_CHUNK, 6), device=dev)], dim=1).contiguous()
    sc_o = sub.origins + sub.viewdirs * (0.5 + z_mid[:, :1])     # plausible surface points
    _, sc_z, sc_delta, sc_mask = sat._sample_block(
        sc_o, -sub.sundirs, torch.zeros_like(sub.t_near), cfg.sc_n_samples, cfg.ray_span,
        True, cfg.cube_bound, gen)
    rayin_sc = torch.cat([sc_o, -sub.sundirs, torch.zeros((N_CHUNK, 10), device=dev)],
                         dim=1).contiguous()
    sc_dm = (sc_delta * sc_mask).contiguous()
    sc_m = sc_mask.float().contiguous()
    z_mid, sc_z = z_mid.contiguous(), sc_z.contiguous()

    # multiply-adds per sample from the field's own (unpadded) layer shapes:
    # trunk + sigma head for the shadow pass, every per-sample matrix for the
    # camera pass; only in-cube samples need them (the rest carry deltam = 0)
    fw = pack_params(field)
    density_macs = sum(x.numel() for x in density_subset(fw) if not is_bias(x))
    camera_macs = sum(x.numel() for x in flatten_weights(fw) if not is_bias(x))
    cases = {
        "camera_fwd": (lambda: fr.camera_forward(kw, rayin, z_mid, deltam),
                       lambda: fr.camera_forward_reference(kw, rayin, z_mid, deltam),
                       z_mid.shape[1], int(mask.sum()), camera_macs,
                       rayin.numel() * 4 + 2 * z_mid.numel() * 4
                       + fr.MAT_ELEMENTS * 2 + fr.BIAS_ELEMENTS * 4 + N_CHUNK * 8 * 4,
                       "_camera_fwd_kernel"),
        "shadow_fwd": (lambda: fr.shadow_forward(kw, rayin_sc, sc_z, sc_dm, sc_m),
                       lambda: fr.shadow_forward_reference(kw, rayin_sc, sc_z, sc_dm, sc_m),
                       sc_z.shape[1], int(sc_mask.sum()), density_macs,
                       rayin_sc.numel() * 4 + 3 * sc_z.numel() * 4
                       + fr.DENSITY_MAT_ELEMENTS * 2 + fr.DENSITY_BIAS_ELEMENTS * 4
                       + N_CHUNK * 4,
                       "_shadow_fwd_kernel"),
    }
    kernel_rows = {}
    for name, (kern, plain, k, n_valid, macs, nbytes, tpu_fn) in cases.items():
        got = kern()
        ref = plain()
        torch.cuda.synchronize()
        err = (got - ref).abs()
        max_err, mean_err = float(err.max()), float(err.mean())
        finite = bool(torch.isfinite(got).all())
        ms = time_ms(torch, kern, 10)
        plain_ms = time_ms(torch, plain, 3)
        # least time: the trunk/head matrix products of the in-cube samples at
        # the bf16 tensor-core peak, against each input read and each output
        # written once at the memory rate
        flops = 2.0 * macs * n_valid
        ops_ms = flops / PEAK_BF16_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        row = {"name": name, "route": "cuda",
               "source": "eonerf_code_tpu_torch/csrc/fused_render.cu",
               "replaces": tpu_kernel_site(tpu_fn), "launches": None,
               "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "library_ms": None}
        kernel_rows[name] = row
        emit({"phase": "kernels", "name": name, "rays": N_CHUNK, "samples": k,
              "kpad": fr.kpad_of(k), "valid_samples": n_valid, "macs_per_sample": macs,
              "max_abs_err": max_err, "mean_abs_err": mean_err,
              "tolerance": KERNEL_TOL, "finite": finite, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": row["bound_ms"], "gflop": flops / 1e9,
              "tflops_achieved": flops / (ms * 1e-3) / 1e12, "card": card})
        if not (finite and max_err <= KERNEL_TOL["max_abs"]
                and mean_err <= KERNEL_TOL["mean_abs"]):
            raise AssertionError(f"{name}: kernel disagrees with its plain version "
                                 f"(max {max_err}, mean {mean_err}, finite {finite})")

    # ---- 3. the main path: a 512x512 nadir sweep with shadows ----
    n_rays = rays_np.shape[0]
    n_chunks = -(-n_rays // N_CHUNK)
    fr.camera_forward.launches = 0
    fr.shadow_forward.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sat.render_image(rf, rays_all, cfg, shadows=True, chunk=N_CHUNK,
                           generator=torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"camera_fwd": fr.camera_forward.launches,
                "shadow_fwd": fr.shadow_forward.launches}
    widths = {"rgb": 3, "albedo_rgb": 3, "ambient_rgb": 3, "shadowless_rgb": 3,
              "opacity_after_surface": 2}
    bad = [k for k in sat.OUTPUT_KEYS
           if tuple(out[k].shape) != (n_rays, widths.get(k, 1))
           or not bool(torch.isfinite(out[k]).all())]
    for name, n in launches.items():
        kernel_rows[name]["launches"] = n
    # the same 1024 rays through the kernels and through the per-sample path
    few = sat.SatRays(*(x[:1024] for x in rays_all))
    with torch.no_grad():
        a = sat.render_rays(rf, few, cfg, True, torch.Generator(device=dev).manual_seed(3))
        b = sat.render_rays(field, few, cfg, True, torch.Generator(device=dev).manual_seed(3))
    path_err = {"depth_mean_abs": float((a["depth"] - b["depth"]).abs().mean()),
                "rgb_mean_abs": float((a["rgb"] - b["rgb"]).abs().mean())}
    # where a chunk's time goes: the two kernels (timed alone in phase 2, one
    # launch each per chunk) against the whole chunk
    kernel_ms = sum(row["ms"] for row in kernel_rows.values())
    emit({"phase": "render", "rays": n_rays, "chunks": n_chunks, "seconds": seconds,
          "rays_per_s": n_rays / seconds, "ms_per_chunk": seconds * 1e3 / n_chunks,
          "kernel_ms_per_chunk": kernel_ms,
          "kernel_share": kernel_ms * n_chunks / (seconds * 1e3),
          "launches": launches, "bad_keys": bad,
          "depth_range": [float(out["depth"].min()), float(out["depth"].max())],
          "vs_per_sample_path": path_err, "tolerance": PATH_TOL, "card": card})
    if bad:
        raise AssertionError(f"render outputs with wrong shape or non-finite values: {bad}")
    if any(n != n_chunks for n in launches.values()):
        raise AssertionError(f"kernel launches {launches} != {n_chunks} chunks")
    if any(path_err[k] > PATH_TOL[k] for k in PATH_TOL):
        raise AssertionError(f"kernel path vs per-sample path: {path_err}")

    # ---- 4. DSM on the card and the registered MAE machinery ----
    t0 = time.perf_counter()
    scale = torch.tensor(scene_scale, dtype=torch.float32, device=dev)
    xyz = (rays_all.origins + rays_all.viewdirs * out["depth"]) * scale  # local metres
    res, half = 0.5, 256.0
    size = int(2 * half / res)
    pred = rasterize_pointcloud(xyz[:, 0], xyz[:, 1], xyz[:, 2], -half, half, res,
                                size, size)
    dx, dy = DSM_SHIFT
    gt = torch.full_like(pred, float("nan"))
    # pred[j + dy, i + dx] aligns with gt[j, i] (the registration convention)
    gt[max(0, -dy):size - max(0, dy), max(0, -dx):size - max(0, dx)] = (
        pred[max(0, dy):size - max(0, -dy), max(0, dx):size - max(0, -dx)] - DSM_ZBIAS)
    mae, (fdx, fdy, bias) = device_dsm_mae(pred, gt)
    torch.cuda.synchronize()
    dsm = {"phase": "dsm", "grid": [size, size], "resolution_m": res,
           "filled": float(torch.isfinite(pred).float().mean()),
           "found_shift": [fdx, fdy], "true_shift": [dx, dy], "bias": float(bias),
           "true_bias": -DSM_ZBIAS, "mae_m": float(mae),
           "seconds": time.perf_counter() - t0, "card": card}
    emit(dsm)
    if (fdx, fdy) != (dx, dy) or abs(float(bias) + DSM_ZBIAS) > 1e-3 or not float(mae) < 1e-3:
        raise AssertionError(f"DSM registration did not recover the known shift: {dsm}")

    emit({"kernels": [kernel_rows["camera_fwd"], kernel_rows["shadow_fwd"]]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
