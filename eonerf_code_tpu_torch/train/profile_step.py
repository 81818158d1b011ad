"""Where a training step's device time goes, by kernel, on one CUDA card.

    python -m eonerf_code_tpu_torch.train.profile_step [--steps 10]
        [--sampler uniform|hierarchical] [--trunk_quant none|int8|int8_full]
        [--bwd_acts saved|recompute]

Builds the training configuration ``chip_smoke.py`` drives (full-width
bf16 field, batch 1024, 128 camera / 64 shadow samples, a synthetic pool
of 2^20 rays over 20 views; ``--sampler hierarchical``: 96 coarse + 48
fine camera samples, as sampler="auto" resolves on a wide envelope;
``--trunk_quant``: the int8 trunk tier, as ``TrainConfig.trunk_quant``;
``--bwd_acts``: the backward from the forward's saved activations, the
default, or the recompute),
takes warm-up steps past the shadow and beta gates, then traces ``--steps``
steps with ``torch.profiler``. Prints one JSON object: device milliseconds
per step for each group of kernels (the fused forwards with or without the
saved stream, the coarse pass, the three passes and the reduction of each
backward (its first pass the recompute, or the heads from the stream), the int8 trunk (one
cluster launch, or the layer-major PE and layer kernels past 16 CTAs a
group) and, for int8_full, its backward chain (one cluster launch, or
the layer-major pair), weight gradient and reduction, Adam, NCCL's
collectives, the rest), the
step's host-clock milliseconds, and the device's idle share (1 - device
kernel time / step time). Exits 1 without a CUDA device, and 2 when the
trace holds no device time.
"""

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time

import torch

# kernel groups by a substring of the CUDA kernel's demangled name (every
# template argument printed), first match wins
# (stream_fwd_kernel<MODE, SAVE>: the streamed forwards, MODE 0 camera, 1
# shadow, 2 coarse, 3 and 4 the per-point field and density; SAVE, the save
# mode that writes the activation stream; fs_count_kernel and
# fs_scan_kernel their plan; fused_fwd_kernel<MODE, BWD, FROM_STREAM>:
# FROM_STREAM, the heads from the activation stream (the int8 tier's, or
# the saved backward's); dgrad_kernel<CAMERA, POINT, TRUNK>,
# wgrad_kernel<CAMERA>)
GROUPS = (
    ("q8_trunk", "q8_trunk_cluster_kernel"),
    ("q8_trunk_layer_major", "q8_layer_kernel"),
    ("q8_pe", "q8_pe_kernel"),
    ("q8_bwd_chain", "q8_chain_cluster_kernel"),
    ("q8_bwd_gamax", "q8_gamax_kernel"),
    ("q8_bwd_dgrad", "q8_dgrad_kernel"),
    ("q8_bwd_wgrad", "q8_wgrad_kernel"),
    ("q8_bwd_reduce", "q8_reduce_kernel"),
    ("q8_bwd_ray_grads", "q8_ray_grads_kernel"),
    ("camera_fwd_save", "stream_fwd_kernel<0, true>"),
    ("shadow_fwd_save", "stream_fwd_kernel<1, true>"),
    ("camera_fwd", "stream_fwd_kernel<0, false>"),
    ("shadow_fwd", "stream_fwd_kernel<1, false>"),
    ("coarse_fwd", "stream_fwd_kernel<2, false>"),
    ("fwd_plan", "fs_count_kernel"),
    ("fwd_plan", "fs_scan_kernel"),
    ("camera_fwd_heads", "fused_fwd_kernel<0, false, true"),
    ("shadow_fwd_heads", "fused_fwd_kernel<1, false, true"),
    ("coarse_fwd_heads", "fused_fwd_kernel<2, false, true"),
    ("camera_bwd_heads", "fused_fwd_kernel<0, true, true"),
    ("shadow_bwd_heads", "fused_fwd_kernel<1, true, true"),
    ("camera_bwd_recompute", "fused_fwd_kernel<0, true, false"),
    ("shadow_bwd_recompute", "fused_fwd_kernel<1, true, false"),
    ("camera_bwd_dgrad", "dgrad_kernel<true"),
    ("shadow_bwd_dgrad", "dgrad_kernel<false"),
    ("camera_bwd_wgrad", "wgrad_kernel<true"),
    ("shadow_bwd_wgrad", "wgrad_kernel<false"),
    ("bwd_reduce", "reduce_kernel"),
    ("adam", "adam"),
    ("nccl", "nccl"),
)


def kernel_group(name):
    for group, key in GROUPS:
        if key in (name.lower() if group == "adam" else name):
            return group
    return "other"


def trace(run, steps, top=10, group_of=kernel_group):
    """``run()`` (``steps`` training steps) under ``torch.profiler``: what
    it returns, the device milliseconds a step of each kernel group (by
    ``group_of(kernel name)``), and the host's self milliseconds a step of
    its ``top`` costliest operations."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = run()
        torch.cuda.synchronize()
    per_group, host = {}, {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_us = getattr(ev, "device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "cuda_time_total", 0.0)
            if dev_us:
                g = group_of(ev.key)
                per_group[g] = per_group.get(g, 0.0) + dev_us / 1e3 / steps
        elif ev.self_cpu_time_total:
            host[ev.key] = ev.self_cpu_time_total / 1e3 / steps
    return out, per_group, dict(sorted(host.items(), key=lambda kv: -kv[1])[:top])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=12)
    ap.add_argument("--sampler", choices=("uniform", "hierarchical"), default="uniform")
    ap.add_argument("--trunk_quant", choices=("none", "int8", "int8_full"), default="none")
    ap.add_argument("--bwd_acts", choices=("saved", "recompute"), default="saved")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1

    from eonerf_code_tpu_torch.config import TrainConfig
    from eonerf_code_tpu_torch.data.synthetic_pool import synthetic_ray_pool
    from eonerf_code_tpu_torch.train.loop import Trainer

    dev = torch.device("cuda")
    logs = tempfile.mkdtemp(prefix="profile_step_", dir=".")
    try:
        cfg = TrainConfig(logs_dir=logs, exp_name="profile", sampler=args.sampler,
                          occ_enabled=False, bwd_acts=args.bwd_acts, compute_dtype="bfloat16",
                          trunk_quant=args.trunk_quant,
                          batch_size=1024, n_samples=128, sc_n_samples=64,
                          first_shadow_step=args.warmup // 2, first_beta_step=args.warmup // 2,
                          save_freq=10 ** 9, seed=0)
        tr = Trainer(cfg, synthetic_ray_pool(1 << 20, 20, dev), n_images=20, device=dev)
        tr.run(max_steps=args.warmup, log_every=10 ** 9)
        torch.cuda.synchronize()

        def timed():
            t0 = time.perf_counter()
            tr.run(max_steps=args.warmup + args.steps, log_every=10 ** 9)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / args.steps

        step_ms, per_group, _ = trace(timed, args.steps)
    finally:
        shutil.rmtree(logs, ignore_errors=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    device_ms = sum(per_group.values())
    print(json.dumps({"sampler": args.sampler, "trunk_quant": args.trunk_quant,
                      "bwd_acts": args.bwd_acts,
                      "steps": args.steps, "ms_per_step": step_ms,
                      "device_ms_per_step": per_group, "device_ms_total": device_ms,
                      "idle_share": 1.0 - device_ms / step_ms if step_ms else None,
                      "card": card}), flush=True)
    return 0 if device_ms > 0 else 2


if __name__ == "__main__":
    sys.exit(main())
