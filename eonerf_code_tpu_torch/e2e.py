"""End-to-end runs of the port on the hermetic synthetic scene: the JAX
package's scripts/run_synthetic_e2e.py (train, render the first val view's
depth, its registered DSM altitude MAE) and scripts/ab_bundle_adjust.py
(RPCs published with a per-view bias of a few pixels, trained without and
with bundle adjustment under coarse-to-fine PE annealing, and the learned
offsets against the injected ones, ``report_learned_offsets``).

    python -m eonerf_code_tpu_torch.e2e synthetic [workdir] [steps] [run ...]
    python -m eonerf_code_tpu_torch.e2e bundle_adjust [workdir] [steps] [bias_px] [arm ...]
    python -m eonerf_code_tpu_torch.e2e vanilla [workdir] [n_frames] [size]
    python -m eonerf_code_tpu_torch.e2e production [--workdir W] [--steps 20000] [--seed 7]
        [--compute_dtype bfloat16] [--trunk_quant none] [--bwd_acts recompute]
        [--sc_n_samples 0] [--n_samples 96]
    python -m eonerf_code_tpu_torch.e2e tall [--workdir W] [--steps 16666]

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
- production and tall (``SCALE_RUNS``) port the JAX package's
  scripts/run_production_scale.py and scripts/run_tall_scale.py: 10 + 2
  views of 320x320 (about 1M training rays), 9 buildings, 1 m GT; the
  production scene compact (sampler "tighten" from step 2000, 96 camera
  and 96 shadow samples, the recompute backward), the tall one 80 m boxes
  over a -2..220 m envelope (``sampler="auto"`` resolves to hierarchical
  96 + 48). Both resume from the newest checkpoint in ``<workdir>/logs``
  and train to milestones at steps/3, 2 steps/3 and steps, skipping those
  already passed; at each, view 0's registered MAE and the sustained
  rays/s; at the end the held-out PSNR of val view 1. A command that is
  killed leaves the checkpoint of the last milestone it passed, and of
  every save_freq steps: the same command again resumes from the newest.
  From a milestone's it goes on in the state of an unbroken run; from a
  save_freq one, mid-epoch, on the same schedule with a fresh shuffle of
  the ray pool (``Trainer.run`` draws one each call). The JAX script's
  ``steps_per_call`` has no counterpart (no megastep in the port; the
  schedule's events fall on the same steps).
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
from eonerf_code_tpu_torch.train.checkpoints import latest_checkpoint
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
# scripts/run_production_scale.py's scene (:36-39) and configuration
# (:44-63, its defaults: bfloat16, no int8 trunk, the recompute backward,
# the shadow march at n_samples) without steps_per_call
PRODUCTION_SCENE = dict(n_views=10, n_test_views=2, img_size=320, extent=400.0, n_buildings=9,
                        box_size=60.0, box_height=24.0, dsm_resolution=1.0,
                        radiometric_jitter=0.08, seed=7)
PRODUCTION = dict(batch_size=4096, n_samples=96, net_depth=8, net_width=256, occ_enabled=True,
                  occ_tighten=True, occ_tighten_start_step=2000, lr_decay_steps=3000,
                  first_shadow_step=6000, first_beta_step=12000, val_freq=10 ** 9, chunk=8192,
                  save_freq=5000, compute_dtype="bfloat16", trunk_quant="none",
                  bwd_acts="recompute", sc_n_samples=0)
# scripts/run_tall_scale.py's (:32-58): the sampler and n_samples at their
# defaults ("auto", 128 -> hierarchical 96 + 48)
TALL_SCENE = dict(n_views=10, n_test_views=2, img_size=320, extent=400.0, n_buildings=9,
                  box_size=60.0, box_height=80.0, min_alt=-2.0, max_alt=220.0,
                  dsm_resolution=1.0, radiometric_jitter=0.08, seed=11)
TALL = dict(batch_size=4096, net_depth=8, net_width=256, lr_decay_steps=3000,
            first_shadow_step=6000, first_beta_step=12000, val_freq=10 ** 9, chunk=8192,
            save_freq=5000, compute_dtype="bfloat16")
# mode: (scene, configuration, default steps, experiment name); the tall
# default is the step of the JAX package's registered figure
SCALE_RUNS = {"production": (PRODUCTION_SCENE, PRODUCTION, 20000, "prod"),
              "tall": (TALL_SCENE, TALL, 16666, "tall")}
SCALE_LOG_EVERY = 2000


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


def scale_config(mode, scene, workdir, steps, **overrides):
    """The TrainConfig of ``mode``'s scale run on ``scene`` (the JAX
    script's, field by field, but steps_per_call), with ``overrides``."""
    _, base, _, exp = SCALE_RUNS[mode]
    return TrainConfig(**{**base, "root_dir": scene["root_dir"], "img_dir": scene["img_dir"],
                          "gt_dir": scene["gt_dir"], "logs_dir": os.path.join(workdir, "logs"),
                          "exp_name": exp, "aoi_id": scene["aoi_id"],
                          "cache_dir": os.path.join(workdir, "cache"),
                          "max_train_steps": int(steps), **overrides})


def milestones(steps):
    return sorted({steps // 3, 2 * steps // 3, steps})


class StepProbe:
    """Wraps a trainer's step function: the time the first step of this
    command ended (after a device sync) and, one a step, whether the
    sampler had the occupancy grid (``tightened``; the trainer's
    ``_occ_for_sampling``, which the loop hands to the step)."""

    def __init__(self, trainer):
        self.trainer, self.first_step_at, self.tightened = trainer, None, []
        self._step = trainer.train_step
        trainer.train_step = self.step

    def step(self, *args, **kwargs):
        self.tightened.append(self.trainer._occ_for_sampling() is not None)
        out = self._step(*args, **kwargs)
        if self.first_step_at is None:
            if self.trainer.device.type == "cuda":
                import torch

                torch.cuda.synchronize(self.trainer.device)
            self.first_step_at = time.perf_counter()
        return out


def span_share(trainer, n=4096):
    """The mean share of the full ray range that a tightened camera ray
    samples (the grid's occupied span over ``n`` evenly spread pool rays),
    or None while the sampler does not take the grid."""
    import torch

    if trainer._occ_for_sampling() is None:
        return None
    rcfg = trainer.rcfg
    idx = torch.linspace(0, trainer.n_rays - 1, min(n, trainer.n_rays),
                         device=trainer.device).long()
    rays = trainer.device_data["rays"][idx]
    near = rays[:, 6]
    t_lo, t_hi = trainer.occ_grid.ray_span(rays[:, 0:3], rays[:, 3:6], near,
                                           near + rcfg.ray_span, n_probes=rcfg.occ_probes,
                                           margin=rcfg.occ_margin)
    return float(((t_hi - t_lo) / rcfg.ray_span).mean())


def _launch_counted():
    """The kernel wrappers of the training and render paths by name; each
    counts its kernel's launches (none on the CPU, where the plain version
    runs)."""
    from eonerf_code_tpu_torch.ops import fused_field as ff
    from eonerf_code_tpu_torch.ops import fused_render as fr

    return {"camera_fwd": fr.camera_forward, "camera_bwd": fr.camera_backward,
            "shadow_fwd": fr.shadow_forward, "shadow_bwd": fr.shadow_backward,
            "coarse_fwd": fr.coarse_forward, "density_fwd": ff.density_forward,
            "camera_fwd_save": fr.camera_forward_save,
            "camera_bwd_saved": fr.camera_backward_saved,
            "shadow_fwd_save": fr.shadow_forward_save,
            "shadow_bwd_saved": fr.shadow_backward_saved}


def view_mae(trainer):
    """View 0's depth render and registered DSM MAE (``_val_mae``)."""
    sample = trainer.val_ds.get_val_sample(0)
    return trainer._val_mae(sample, trainer.render_view(sample, depth_only=True))


def scale_run(mode, workdir=None, steps=None, device="cuda", seed=None, scene_spec=None,
              log_every=SCALE_LOG_EVERY, **overrides):
    """The JAX package's production or tall script through the port:
    generate the scene, resume from the newest checkpoint, train to each
    milestone not yet passed (view 0's MAE and rays/s at each), then the
    held-out PSNR of val view 1. ``scene_spec`` and
    ``overrides`` cut the sizes, for tests. Returns the summary dict it
    prints last."""
    from eonerf_code_tpu_torch import native
    from eonerf_code_tpu_torch.utils import metrics as M

    t_cmd = time.perf_counter()
    scene_kw, _, default_steps, exp = SCALE_RUNS[mode]
    steps = int(steps or default_steps)
    workdir = workdir or os.path.join("logs", f"e2e_{mode}")
    native.build()
    if str(device).startswith("cuda"):
        from eonerf_code_tpu_torch.ops import _build

        _build.build()
    build_s = time.perf_counter() - t_cmd
    spec = {**scene_kw, **({} if seed is None else {"seed": int(seed)}), **(scene_spec or {})}
    t0 = time.perf_counter()
    scene = make_scene(workdir, "scene", **spec)
    scene_s = time.perf_counter() - t0
    cfg = scale_config(mode, scene, workdir, steps, **overrides)
    ckpt = latest_checkpoint(os.path.join(cfg.logs_dir, cfg.exp_name))
    if ckpt:
        print(f"resuming from {ckpt}", flush=True)
        cfg.ckpt_path = ckpt
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=device)
    trainer_s = time.perf_counter() - t0
    start_step = trainer.step
    print(json.dumps({"mode": mode, "workdir": workdir, "rays": trainer.n_rays,
                      "images": trainer.n_images, "resumed_from": ckpt,
                      "start_step": start_step, "sampler": cfg.sampler,
                      "n_samples": cfg.n_samples, "n_importance": cfg.n_importance,
                      "sc_n_samples": cfg.sc_n_samples, "build_s": build_s,
                      "scene_s": scene_s, "trainer_s": trainer_s}), flush=True)
    probe = StepProbe(trainer)
    counted = _launch_counted()
    for fn in counted.values():
        fn.launches = 0
    done = []
    for target in milestones(steps):
        if target <= trainer.step:           # resumed past this milestone already
            continue
        t0 = time.perf_counter()
        stats = trainer.run(max_steps=target, log_every=log_every)
        seconds = time.perf_counter() - t0
        mae = view_mae(trainer)
        res = {"mode": mode, "step": target, "mae_m": mae, "rays_per_s": stats["rays_per_sec"],
               "seconds": seconds, "span_share": span_share(trainer)}
        done.append(res)
        print(json.dumps(res), flush=True)
    out = {"mode": mode, "summary": True, "steps": trainer.step, "target_steps": steps,
           "start_step": start_step, "sampler": cfg.sampler, "milestones": done,
           "first_step_s": (None if probe.first_step_at is None
                            else probe.first_step_at - t_cmd),
           "tightened_steps": sum(probe.tightened),
           "tighten_opened_at": (start_step + probe.tightened.index(True)
                                 if any(probe.tightened) else None),
           "tighten_active": trainer._occ_for_sampling() is not None,
           "span_share": span_share(trainer),
           "launches": {name: fn.launches for name, fn in counted.items()},
           # a finished checkpoint trains nothing: report its MAE
           "mae_m": done[-1]["mae_m"] if done else view_mae(trainer)}
    sample = trainer.val_ds.get_val_sample(1)
    rgb = trainer.render_view(sample)["rgb"]
    out["psnr_db"] = float(M.psnr(rgb.float(), rgb.new_tensor(sample["rgbs"]).float()))
    out["seconds"] = time.perf_counter() - t_cmd
    print(json.dumps(out), flush=True)
    return out


def _scale_args(mode, args, device):
    import argparse

    ap = argparse.ArgumentParser(prog=f"python -m eonerf_code_tpu_torch.e2e {mode}")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--steps", type=int, default=SCALE_RUNS[mode][2])
    if mode == "production":
        ap.add_argument("--seed", type=int, default=None, help="the scene's seed")
        ap.add_argument("--compute_dtype", default=PRODUCTION["compute_dtype"])
        ap.add_argument("--trunk_quant", default=PRODUCTION["trunk_quant"])
        ap.add_argument("--bwd_acts", default=PRODUCTION["bwd_acts"])
        ap.add_argument("--sc_n_samples", type=int, default=PRODUCTION["sc_n_samples"])
        ap.add_argument("--n_samples", type=int, default=PRODUCTION["n_samples"])
    ns = vars(ap.parse_args(args))
    return scale_run(mode, ns.pop("workdir"), ns.pop("steps"), device, ns.pop("seed", None),
                     **ns)


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    if not args or args[0] not in ("synthetic", "bundle_adjust", "vanilla", *SCALE_RUNS):
        raise SystemExit(__doc__)
    mode, rest = args[0], args[1:]
    if mode in SCALE_RUNS:
        return _scale_args(mode, rest, device)
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
