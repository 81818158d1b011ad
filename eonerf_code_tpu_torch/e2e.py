"""End-to-end runs of the port on the hermetic synthetic scene: the JAX
package's scripts/run_synthetic_e2e.py (train, render the first val view's
depth, its registered DSM altitude MAE) and scripts/ab_bundle_adjust.py
(RPCs published with a per-view bias of a few pixels, trained without and
with bundle adjustment under coarse-to-fine PE annealing, and the learned
offsets against the injected ones, ``report_learned_offsets``).

    python -m eonerf_code_tpu_torch.e2e synthetic [workdir] [steps] [run ...]
    python -m eonerf_code_tpu_torch.e2e bundle_adjust [workdir] [steps] [bias_px] [arm ...]
    python -m eonerf_code_tpu_torch.e2e vanilla [workdir] [n_frames] [size]

``--device cpu`` anywhere in the arguments runs on the host (slowly);
the card otherwise. Each run prints one JSON line.

- synthetic runs (``RUNS``), on the JAX convergence pin's scene and
  configuration (tests/test_convergence_slow.py): A, the pin's own (8x128,
  float32: the per-sample path); B, the production width (8x256, bfloat16:
  the fused kernels); C and D, B with the int8 and the int8_full trunk
  (recompute backward).
- bundle_adjust arms (``ARMS``), at B's configuration on the script's
  small scene with ``rpc_bias_px`` 3: ``biased`` (no bundle adjustment) and
  ``biased+ba`` (``rpc_correction``, full PE bandwidth at steps // 2, the
  script's rule).
- vanilla writes a nerf_synthetic scene of the JAX vanilla pin's kind
  (tests/test_blender.py:10-40), 8 frames of 100x100 by default, for
  train_mlp_nerf_torch.py (``--data_root <workdir>/blender --scene
  minicube``); it trains nothing.
"""

import json
import os
import sys
import time

import numpy as np

from eonerf_code_tpu_torch.config import TrainConfig
from eonerf_code_tpu_torch.data.synthetic import SyntheticSceneSpec, generate_scene
from eonerf_code_tpu_torch.geo.bundle_adjust import rpc_offset_from_scene_offset
from eonerf_code_tpu_torch.io.png import write_png
from eonerf_code_tpu_torch.train.loop import Trainer

# the JAX pin's scene and configuration (tests/test_convergence_slow.py:20-29)
SCENE = dict(n_views=5, n_test_views=1, img_size=64, dsm_resolution=2.0)
PIN = dict(batch_size=2048, n_samples=64, net_depth=8, net_width=128, occ_enabled=False,
           lr_decay_steps=1000, first_shadow_step=1500, first_beta_step=10 ** 9,
           val_freq=10 ** 9, chunk=4096, seed=0)
WIDE = dict(net_width=256, compute_dtype="bfloat16")
RUNS = {"A": {}, "B": WIDE,
        "C": dict(WIDE, trunk_quant="int8", bwd_acts="recompute"),
        "D": dict(WIDE, trunk_quant="int8_full", bwd_acts="recompute")}
# scripts/ab_bundle_adjust.py's small scene (:132-134) and its default bias
BA_SCENE = dict(SCENE, seed=3)
BIAS_PX = 3.0
ARMS = {"biased": {}, "biased+ba": dict(rpc_correction=True)}
STEPS = 2000
LOG_EVERY = 100
# the vanilla scene's frames and size (chip_smoke.py's phase vanilla)
BLENDER = dict(n_frames=8, size=100)


def make_scene(workdir, name, **spec):
    """generate_scene under ``workdir/name``; its info dict."""
    return generate_scene(os.path.join(workdir, name), SyntheticSceneSpec(**spec))


def make_trainer(scene, workdir, name, steps=STEPS, device="cuda", **overrides):
    """A Trainer on ``scene`` at the pin's configuration with ``overrides``,
    the validation MAE on the device (``device_eval=True``: a failure
    raises, no host fallback)."""
    cfg = TrainConfig(**{**PIN, "root_dir": scene["root_dir"], "img_dir": scene["img_dir"],
                         "gt_dir": scene["gt_dir"], "aoi_id": scene["aoi_id"],
                         "logs_dir": os.path.join(workdir, "logs"), "exp_name": name,
                         "max_train_steps": steps, "device_eval": True, **overrides})
    return Trainer(cfg, device=device)


def arm_overrides(arm, steps):
    """An arm's TrainConfig overrides: ``biased+ba`` anneals to steps // 2."""
    out = dict(WIDE, **ARMS[arm])
    if out.get("rpc_correction"):
        out["freq_reg_end_step"] = max(steps // 2, 1)
    return out


def score(trainer):
    """The first val view's depth render, then its registered DSM MAE on
    the device (``_val_mae``) and the registration: {"mae_m", "shift",
    "bias_m"}; a shift at +-5 cells is the search's edge (a failed
    registration)."""
    sample = trainer.val_ds.get_val_sample(0)
    pred = trainer.render_view(sample, depth_only=True)
    mae = trainer._val_mae(sample, pred)
    _, (dx, dy, bias) = trainer.val_dsm_device(sample, pred)
    return {"mae_m": mae, "shift": [int(dx), int(dy)], "bias_m": float(bias)}


def last_logged(trainer, tags=("train/loss", "train/psnr")):
    """{tag: (step, value)} of the last logged value of each tag."""
    trainer.logger.flush()
    out = {}
    with open(os.path.join(trainer.log_dir, "metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            if r["tag"] in tags:
                out[r["tag"]] = (r["step"], r["value"])
    return out


def train_and_score(trainer, steps=STEPS, log_every=LOG_EVERY):
    """Train to ``steps`` and score: steps, seconds, rays/s (of this call),
    the last logged loss and PSNR, the MAE and registration."""
    t0 = time.perf_counter()
    stats = trainer.run(max_steps=steps, log_every=log_every)
    seconds = time.perf_counter() - t0
    logged = last_logged(trainer)
    return {"steps": stats["steps"], "seconds": seconds, "rays_per_s": stats["rays_per_sec"],
            "final_loss": logged["train/loss"][1], "final_psnr": logged["train/psnr"][1],
            "logged_at_step": logged["train/loss"][0], **score(trainer)}


def report_learned_offsets(trainer, scene):
    """The learned ray-bundle offsets in image space against the injected
    RPC biases (scripts/ab_bundle_adjust.py's ``report_learned_offsets``).
    Bundle adjustment fixes only the inconsistent part of the
    miscalibration (a common shift is gauge freedom the registration
    absorbs), and the learned shift moves the rays where the bias moved the
    camera: both are mean-centred and sign-matched. Returns {"views": [...],
    "sign", "corr" (the sign-matched correlation of the centred offsets),
    "median_resid_px", "mean_injected_px"}."""
    ds = trainer.train_ds
    emb = trainer.field.ray_correction_enc.weight.detach().double().cpu().numpy()
    zonestring = ds.scene.utm_zonestring
    south = zonestring[-1] < "N"
    rows = []
    for i, name in enumerate(scene["names"][:emb.shape[0]]):
        if name not in scene["rpc_biases_px"]:
            continue
        dc_inj, dr_inj = scene["rpc_biases_px"][name]
        d_col, d_row = rpc_offset_from_scene_offset(ds.all_rpcs[i], emb[i], ds.scene.scene_scale,
                                                    ds.scene.scene_offset, zonestring,
                                                    south=south)
        rows.append((name, dc_inj, dr_inj, d_col, d_row))
    inj = np.array([[r[1], r[2]] for r in rows])
    got = np.array([[r[3], r[4]] for r in rows])
    inj_c = inj - inj.mean(0)
    got_c = got - got.mean(0)
    sign = -1.0 if np.sum(inj_c * got_c) < 0 else 1.0
    resid = np.hypot(*(inj_c - sign * got_c).T)
    den = np.linalg.norm(inj_c) * np.linalg.norm(got_c)
    corr = float(np.sum(inj_c * sign * got_c) / den) if den > 0 else 0.0
    print("  learned vs injected RPC offsets (mean-centered px):", flush=True)
    for (name, dci, dri, dcg, drg), r in zip(rows, resid):
        print(f"    {name}: injected=({dci:+.2f},{dri:+.2f})  "
              f"learned=({sign * dcg:+.2f},{sign * drg:+.2f})  resid={r:.2f}px", flush=True)
    print(f"  median |resid| = {np.median(resid):.2f} px (mean |injected|, centered: "
          f"{np.hypot(*inj_c.T).mean():.2f} px), corr {corr:+.3f}", flush=True)
    return {"views": [{"name": n, "injected_px": [a, b], "learned_px": [c, d]}
                      for n, a, b, c, d in rows],
            "sign": sign, "corr": corr, "median_resid_px": float(np.median(resid)),
            "mean_injected_px": float(np.hypot(*inj_c.T).mean())}


def synthetic(workdir, steps=STEPS, runs=tuple(RUNS), device="cuda", scene_spec=None,
              **overrides):
    """The quality runs on one scene: {run: result}. ``scene_spec`` and
    ``overrides`` (every run's) cut the sizes, for tests."""
    scene = make_scene(workdir, "scene", **(scene_spec or SCENE))
    out = {}
    for run in runs:
        trainer = make_trainer(scene, workdir, f"e2e_{run}", steps, device,
                               **{**RUNS[run], **overrides})
        out[run] = train_and_score(trainer, steps)
        print(json.dumps({"run": run, **out[run]}), flush=True)
    return out


def bundle_adjust(workdir, steps=STEPS, bias_px=BIAS_PX, arms=tuple(ARMS), device="cuda",
                  scene_spec=None, **overrides):
    """The bundle-adjustment arms on the biased scene: {arm: result}, the
    ``biased+ba`` result with its ``offsets`` (report_learned_offsets)."""
    scene = make_scene(workdir, "scene_biased", rpc_bias_px=bias_px,
                       **(scene_spec or BA_SCENE))
    out = {}
    for arm in arms:
        trainer = make_trainer(scene, workdir, f"ba_{arm}", steps, device,
                               **{**arm_overrides(arm, steps), **overrides})
        out[arm] = train_and_score(trainer, steps)
        if trainer.cfg.rpc_correction:
            out[arm]["offsets"] = report_learned_offsets(trainer, scene)
        print(json.dumps({"arm": arm, **out[arm]}), flush=True)
    return out


def blender_scene(root, subject="minicube", n_frames=3, size=24):
    """The JAX vanilla pin's nerf_synthetic subject (tests/test_blender.py:
    10-40; its defaults): cameras on a circle of radius 4 about the origin
    looking at it, y up (OpenGL), each frame the same disc (a sphere at the
    origin) on a transparent background; one pose list for the train, val
    and test splits. Returns (root, subject)."""
    sub = os.path.join(root, subject)
    os.makedirs(sub, exist_ok=True)
    frames = []
    for i in range(n_frames):
        theta = 2 * np.pi * i / n_frames
        pos = np.array([4 * np.sin(theta), 0.0, 4 * np.cos(theta)])
        z = pos / np.linalg.norm(pos)          # the camera looks along -z
        x = np.cross(np.array([0.0, 1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, np.cross(z, x), z, pos
        img = np.zeros((size, size, 4), np.uint8)
        yy, xx = np.mgrid[0:size, 0:size]
        img[(xx - size / 2) ** 2 + (yy - size / 2) ** 2 < (size / 4) ** 2] = [240, 220, 200, 255]
        write_png(os.path.join(sub, f"r_{i}.png"), img)
        frames.append({"file_path": f"r_{i}", "transform_matrix": c2w.tolist()})
    meta = {"camera_angle_x": 0.7, "frames": frames}
    for split in ("train", "val", "test"):
        with open(os.path.join(sub, f"transforms_{split}.json"), "w") as f:
            json.dump(meta, f)
    return root, subject


def vanilla(workdir, n_frames=BLENDER["n_frames"], size=BLENDER["size"]):
    """Write the vanilla scene under ``workdir/blender``; (root, subject)."""
    root, subject = blender_scene(os.path.join(workdir, "blender"), n_frames=n_frames,
                                  size=size)
    print(json.dumps({"data_root": root, "scene": subject, "n_frames": n_frames,
                      "size": size}), flush=True)
    return root, subject


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    if not args or args[0] not in ("synthetic", "bundle_adjust", "vanilla"):
        raise SystemExit(__doc__)
    mode, rest = args[0], args[1:]
    workdir = rest[0] if rest else "logs/e2e"
    if mode == "vanilla":
        return vanilla(workdir, *(int(v) for v in rest[1:3]))
    steps = int(rest[1]) if len(rest) > 1 else STEPS
    if mode == "synthetic":
        return synthetic(workdir, steps, tuple(rest[2:]) or tuple(RUNS), device)
    bias_px = float(rest[2]) if len(rest) > 2 else BIAS_PX
    return bundle_adjust(workdir, steps, bias_px, tuple(rest[3:]) or tuple(ARMS), device)


if __name__ == "__main__":
    main()
