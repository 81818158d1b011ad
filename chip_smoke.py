#!/usr/bin/env python3
"""Drive the PyTorch port's render-and-DSM path and its training step once
on one CUDA card.

    python3 chip_smoke.py

Phases (one JSON line each; any failure raises and exits non-zero):

1. build   - nvcc builds the fused-render kernels from the checkout
             (eonerf_code_tpu_torch/csrc/fused_render.cu) into the
             git-ignored eonerf_code_tpu_torch/_build/.
2. kernels - the camera and shadow forward kernels against their plain
             PyTorch versions at the render path's shapes (4096 rays;
             camera K=127, shadow K=63; full 8x256 bf16 field), and the
             camera and shadow backward kernels at the training shapes
             (1024 rays, a random cotangent): errors, kernel / plain /
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
5. train   - Trainer.run takes 20 steps (batch 1024, 128 camera and 64
             shadow samples, shadows and the beta loss from step 10) of a
             full-width bf16 field on a device-resident pool of 2^20
             seeded rays over 20 oblique views with their own sun
             directions. Every loss must be finite, the parameters must
             move, each kernel must launch once per step that runs it, and
             on one batch the whole-step gradient through the kernels must
             agree with the gradient through the per-sample module path.
             Then 10 more steps are timed: rays/s and ms per step split
             into forward kernels, backward kernels, optimizer and the rest.

Then the kernels summary line, the card's name and power limit as
nvidia-smi reports them, and last {"ok": true, "device": {...}}.
Exits non-zero without printing results when no CUDA device is present.
"""

import json
import math
import pathlib
import shutil
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
# Backward kernel vs plain version, per gradient tensor and for d_rayin:
# the same rounding points, another summation order. The difference is
# dominated by ReLU masks that flip between the two recomputed forwards at
# the few samples that carry most of a ray's cotangent; over 1024 rays the
# worst tensor stayed under 0.9 % in tests/test_torch_cuda.py.
BWD_REL_L2 = 1e-2
N_TRAIN = 1024             # rays per training batch (TrainConfig's default)
N_POOL = 1 << 20           # rays in the training pool
N_VIEWS = 20
TRAIN_STEPS = 20
TIMED_STEPS = 10
# Whole-step gradient through the kernels vs through the per-sample module
# path (autograd through EONerfField) on one batch: the per-sample path
# rounds as flax does (bf16 bias adds and heads), the kernels keep f32 bias
# adds and heads. Measured 3.9e-3 on NVIDIA H100 80GB HBM3, 700 W; held at
# 5x that.
GRAD_PATH_REL_L2 = 2e-2
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


def grad_errors(torch, fr, flatten_weights, got, ref):
    """rel-L2 of each of the 36 weight-gradient tensors and of d_rayin, and
    the max abs difference over all of them."""
    views = [flatten_weights(fr.kernel_views(fr.KernelWeights(m, b))) for m, b, _ in (got, ref)]
    rel = []
    for a, b in list(zip(*views)) + [(got[2], ref[2])]:
        den = float(b.norm())
        rel.append(float((a - b).norm()) / den if den > 0 else float(a.norm()))
    max_abs = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    return rel, max_abs


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
    with torch.no_grad():
        kw = fr.pack_kernel_weights(pack_params(field), torch.bfloat16)
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

    # backward kernels at the training shapes: the first N_TRAIN rays of the
    # same inputs, a random per-ray cotangent
    nb = N_TRAIN
    b_in = [t[:nb].contiguous() for t in (rayin, z_mid, deltam)]
    b_sc = [t[:nb].contiguous() for t in (rayin_sc, sc_z, sc_dm, sc_m)]
    gacc = torch.randn((nb, fr.ACC_COLS), generator=gen, device=dev)
    ggeo = torch.randn((nb,), generator=gen, device=dev)
    bwd_cases = {
        "camera_bwd": (lambda: fr.camera_backward(kw, *b_in, gacc),
                       lambda: fr.camera_backward_reference(kw, *b_in, gacc),
                       int(mask[:nb].sum()), camera_macs,
                       sum(t.numel() * 4 for t in b_in) + gacc.numel() * 4
                       + fr.MAT_ELEMENTS * (2 + 4) + fr.BIAS_ELEMENTS * (4 + 4)
                       + nb * fr.RAYIN_COLS * 4,
                       "_camera_bwd_kernel"),
        "shadow_bwd": (lambda: fr.shadow_backward(kw, *b_sc, ggeo),
                       lambda: fr.shadow_backward_reference(kw, *b_sc, ggeo),
                       int(sc_mask[:nb].sum()), density_macs,
                       sum(t.numel() * 4 for t in b_sc) + ggeo.numel() * 4
                       + fr.DENSITY_MAT_ELEMENTS * (2 + 4) + fr.DENSITY_BIAS_ELEMENTS * (4 + 4)
                       + nb * fr.RAYIN_COLS * 4,
                       "_shadow_bwd_kernel"),
    }
    for name, (kern, plain, n_valid, macs, nbytes, tpu_fn) in bwd_cases.items():
        got = kern()
        ref = plain()
        torch.cuda.synchronize()
        rel, max_err = grad_errors(torch, fr, flatten_weights, got, ref)
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        ms = time_ms(torch, kern, 10)
        plain_ms = time_ms(torch, plain, 3)
        # least time: recompute, dgrad and wgrad, each the forward's
        # multiply-adds per in-cube sample, at the bf16 tensor-core peak
        flops = 3 * 2.0 * macs * n_valid
        ops_ms = flops / PEAK_BF16_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        kernel_rows[name] = {
            "name": name, "route": "cuda", "source": "eonerf_code_tpu_torch/csrc/fused_render.cu",
            "replaces": tpu_kernel_site(tpu_fn), "launches": None, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None}
        emit({"phase": "kernels", "name": name, "rays": nb,
              "samples": (b_in if name == "camera_bwd" else b_sc)[1].shape[1],
              "valid_samples": n_valid, "max_rel_l2": max(rel), "rel_l2_d_rayin": rel[-1],
              "max_abs_err": max_err, "tolerance_rel_l2": BWD_REL_L2, "finite": finite,
              "ms": ms, "plain_ms": plain_ms, "bound_ms": kernel_rows[name]["bound_ms"],
              "gflop": flops / 1e9, "tflops_achieved": flops / (ms * 1e-3) / 1e12,
              "card": card})
        if not (finite and max(rel) <= BWD_REL_L2):
            raise AssertionError(f"{name}: kernel disagrees with its plain version (rel-L2 {rel})")
    # the forward kernels at the training shapes, for the step's time split
    train_fwd_ms = (time_ms(torch, lambda: fr.camera_forward(kw, *b_in), 10)
                    + time_ms(torch, lambda: fr.shadow_forward(kw, *b_sc), 10))

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

    # ---- 5. training steps through the forward and backward kernels ----
    from eonerf_code_tpu_torch.config import TrainConfig
    from eonerf_code_tpu_torch.data.synthetic_pool import synthetic_ray_pool
    from eonerf_code_tpu_torch.train.loop import Trainer, make_loss_fn

    log_root = ROOT / "logs"
    shutil.rmtree(log_root / "chip_smoke", ignore_errors=True)
    cfg_t = TrainConfig(logs_dir=str(log_root), exp_name="chip_smoke", sampler="uniform",
                        occ_enabled=False, bwd_acts="recompute", compute_dtype="bfloat16",
                        batch_size=N_TRAIN, n_samples=128, sc_n_samples=64,
                        first_shadow_step=TRAIN_STEPS // 2, first_beta_step=TRAIN_STEPS // 2,
                        max_train_steps=TRAIN_STEPS, save_freq=10 ** 9, seed=0)
    tr = Trainer(cfg_t, synthetic_ray_pool(N_POOL, N_VIEWS, dev), n_images=N_VIEWS, device=dev)
    if not isinstance(tr.render_field, KernelField):
        raise RuntimeError("the trainer did not pick the kernels for a bf16 8x256 field")
    before = [p.detach().clone() for p in tr.field.parameters()]
    counted = (fr.camera_forward, fr.shadow_forward, fr.camera_backward, fr.shadow_backward)
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(max_steps=TRAIN_STEPS, log_every=1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches_t = dict(zip(("camera_fwd", "shadow_fwd", "camera_bwd", "shadow_bwd"),
                          (fn.launches for fn in counted)))
    for name in ("camera_bwd", "shadow_bwd"):
        kernel_rows[name]["launches"] = launches_t[name]
    rows = [json.loads(line) for line in (log_root / "chip_smoke" / "metrics.jsonl").open()]
    losses = [r["value"] for r in rows if r["tag"] == "train/loss"]
    moved = sum(not torch.equal(a, p) for a, p in zip(before, tr.field.parameters()))
    shadow_steps = TRAIN_STEPS - TRAIN_STEPS // 2
    expect = {"camera_fwd": TRAIN_STEPS, "camera_bwd": TRAIN_STEPS,
              "shadow_fwd": shadow_steps, "shadow_bwd": shadow_steps}
    # timed steady steps (shadows and beta on)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(max_steps=TRAIN_STEPS + TIMED_STEPS, log_every=10 ** 9)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    opt_ms = time_ms(torch, tr.optimizer.step, 10)
    fwd_ms = train_fwd_ms
    bwd_ms = kernel_rows["camera_bwd"]["ms"] + kernel_rows["shadow_bwd"]["ms"]
    # one batch: the whole-step gradient through the kernels vs through the
    # per-sample module path, same sampling draws
    batch = {k: v[:N_TRAIN] for k, v in tr.device_data.items()}
    grads = []
    for rfield in (tr.render_field, tr.field):
        tr.field.zero_grad(set_to_none=True)
        loss, _ = make_loss_fn(rfield, tr.rcfg)(batch, 0.0, True, True,
                                                torch.Generator(device=dev).manual_seed(5))
        loss.backward()
        grads.append(torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                                .float().flatten() for p in tr.field.parameters()]))
    grad_rel = float((grads[0] - grads[1]).norm() / grads[1].norm())
    train = {"phase": "train", "steps": TRAIN_STEPS, "batch": N_TRAIN, "pool_rays": N_POOL,
             "views": N_VIEWS, "first_run_s": first_s, "losses_finite": len(losses) == TRAIN_STEPS
             and all(math.isfinite(v) for v in losses), "loss_first_last": [losses[0], losses[-1]],
             "param_tensors_moved": moved, "param_tensors": len(before), "launches": launches_t,
             "expected_launches": expect, "grad_vs_per_sample_rel_l2": grad_rel,
             "tolerance": GRAD_PATH_REL_L2, "rays_per_s": N_TRAIN / (step_ms * 1e-3),
             "ms_per_step": step_ms, "ms_fwd_kernels": fwd_ms, "ms_bwd_kernels": bwd_ms,
             "ms_optimizer": opt_ms, "ms_rest": step_ms - fwd_ms - bwd_ms - opt_ms,
             "card": card}
    emit(train)
    if not train["losses_finite"] or moved == 0:
        raise AssertionError(f"training did not run cleanly: {train}")
    if launches_t != expect:
        raise AssertionError(f"kernel launches {launches_t} != {expect}")
    if not grad_rel <= GRAD_PATH_REL_L2:
        raise AssertionError(f"kernel-path gradient vs per-sample path: rel-L2 {grad_rel}")

    emit({"kernels": [kernel_rows[n] for n in ("camera_fwd", "shadow_fwd", "camera_bwd",
                                               "shadow_bwd")]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
