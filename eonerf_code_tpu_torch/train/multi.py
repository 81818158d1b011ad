"""Multi-AOI training from the command line (the JAX package's
train/multi.py, its flags, defaults and argument errors), over
parallel/multi_aoi.py:

    python train_multi_aoi_torch.py \\
        --root_dirs sceneA,sceneB --img_dirs imgsA,imgsB \\
        --gt_dirs gtA,gtB --logs_dir logs --exp_name pod0 \\
        --scene_axis 2 --data_axis 4 --max_train_steps 20000

Each scene lands in its own run directory ``logs_dir/exp_name/<aoi_id>/``
in the single-AOI contract (opts.json with the resolved sampler, sample
counts, occupancy flags and backend; ``ckpts/epoch=<steps>`` with the
parameters and the occupancy grid; the ``occ_sampling.json`` sidecar), so
the eval CLI takes every scene as it is:

    python eval_eonerf_torch.py pod0/<aoi_id> --logs_dir logs --dsm

The mesh: ``--scene_axis`` scene groups of ``--data_axis`` processes, one a
card (0: the JAX rule over the visible cards: the scene count when it
divides them, else 1; the data axis takes the rest); the entry point spawns
them (``parallel.mesh.launch``) or joins ``torchrun``'s. Every rank reads
every scene's data; rank 0 of the mesh prints and writes everything (the
pod checkpoints, each scene's metrics and run directory). Pod resume:
``--resume`` continues from the newest ``_pod`` checkpoint, bit for bit.
"""

import argparse
import os
import sys
import time

import torch


def _split(s):
    return [x for x in (s or "").split(",") if x]


def _split_keep(s, n, flag):
    """Comma-split keeping EMPTY slots (a scene without this input), e.g.
    --init_dsm_paths dsmA.tif,,dsmC.tif for 3 scenes; [None] * n when the
    flag is unset."""
    if not s:
        return [None] * n
    out = [x.strip() or None for x in s.split(",")]
    if len(out) != n:
        raise SystemExit(f"error: {flag} must have one (possibly empty) "
                         f"entry per scene ({len(out)} given, {n} scenes)")
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="EO-NeRF on PyTorch and CUDA: multi-AOI "
                                            "scene-parallel training")
    p.add_argument("--root_dirs", type=str, required=True,
                   help="comma-separated per-AOI metadata dirs")
    p.add_argument("--img_dirs", type=str, required=True,
                   help="comma-separated per-AOI image dirs")
    p.add_argument("--gt_dirs", type=str, default="",
                   help="comma-separated per-AOI lidar GT dirs (optional; recorded in each "
                        "scene's opts.json for eval)")
    p.add_argument("--aoi_ids", type=str, default="",
                   help="comma-separated AOI ids, one per scene: recorded in each scene's "
                        "opts.json (GT rasters resolve as <aoi_id>_DSM.tif) and used as the "
                        "run-dir names (default: basename of each root_dir, aoi_id inferred "
                        "by eval)")
    p.add_argument("--logs_dir", type=str, default="logs")
    p.add_argument("--exp_name", type=str, required=True)
    p.add_argument("--scene_axis", type=int, default=0,
                   help="scene groups, one or more cards each (0 = auto: the scene count "
                        "when it divides the visible cards, else 1)")
    p.add_argument("--data_axis", type=int, default=0,
                   help="processes on the data axis of each scene group, one a card (0 = "
                        "the remaining cards)")
    p.add_argument("--max_train_steps", type=int, default=20000)
    p.add_argument("--batch_size", type=int, default=1024, help="rays per step PER SCENE")
    p.add_argument("--n_samples", type=int, default=64)
    p.add_argument("--sc_n_samples", type=int, default=-1,
                   help="shadow-march samples per solar ray (-1 = auto: min(n, max(n//2, "
                        "64)); 0 = follow --n_samples)")
    p.add_argument("--n_importance", type=int, default=0,
                   help="hierarchical fine samples per ray (sampler=hierarchical sets the "
                        "validated shape itself)")
    p.add_argument("--sampler", type=str, default="auto",
                   choices=["auto", "uniform", "tighten", "hierarchical"],
                   help="camera sampling mode. auto resolves from the WORST scene's "
                        "altitude envelope (every scene compact -> occupancy tightening, "
                        "any wide scene -> hierarchical for ALL)")
    p.add_argument("--occ_tighten_start_step", type=int, default=2000)
    p.add_argument("--n_grid", type=int, default=64, help="occupancy grid resolution per scene")
    p.add_argument("--rpc_correction", action="store_true", default=False,
                   help="learnable per-image ray-bundle offsets per scene (RPC bundle "
                        "adjustment; combine with --freq_reg_end_step for convergence)")
    p.add_argument("--init_dsm_paths", type=str, default="",
                   help="comma-separated per-scene external DSMs for the depth-prior loss; "
                        "leave a slot EMPTY for scenes without one (e.g. a.tif,,c.tif): "
                        "prior-less scenes see neutral sentinels")
    p.add_argument("--init_conf_paths", type=str, default="",
                   help="comma-separated per-scene SGM confidence rasters (optional, same "
                        "empty-slot rule)")
    p.add_argument("--shadow_masks_dirs", type=str, default="",
                   help="comma-separated per-scene shadow-mask dirs for the shadow-prior "
                        "loss (same empty-slot rule)")
    p.add_argument("--fc_layers", type=int, default=8)
    p.add_argument("--fc_units", type=int, default=256)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--lr_decay_steps", type=int, default=None,
                   help="StepLR decay interval (lr *= 0.9 every N steps; default: constant "
                        "lr)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--first_shadow_step", type=int, default=None,
                   help="step at which the geometric shadow pass turns on (default: the "
                        "single-AOI trainer's epoch-2 equivalent; 0 = from the start)")
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--use_pallas", type=str, default="auto", choices=["auto", "true", "false"],
                   help="the fused kernels (auto = on for bf16 on the card with the 8x256 "
                        "architecture)")
    p.add_argument("--bwd_acts", type=str, default="saved", choices=["recompute", "saved"],
                   help="fused-kernel backward: read the trunk activations the forward saved "
                        "(default) or recompute them")
    p.add_argument("--freq_reg_end_step", type=int, default=0,
                   help="coarse-to-fine PE annealing ramp end (0 = off)")
    p.add_argument("--freq_reg_start_step", type=int, default=0)
    p.add_argument("--save_freq", type=int, default=0,
                   help="pod-checkpoint every N steps into <logs>/<exp>/_pod/ckpts (stacked "
                        "params + opt + occ + step; 0 = final checkpoint only). Per-scene "
                        "eval-contract run dirs are always written at the end of the run")
    p.add_argument("--resume", action="store_true", default=False,
                   help="resume from the latest pod checkpoint under <logs>/<exp>/_pod if one "
                        "exists (fresh start otherwise). The random numbers derive from "
                        "(seed, step, scene), so a resumed run is bit-identical to an "
                        "uninterrupted one")
    return p.parse_args(argv)


def _plan(args):
    """The argument checks of the JAX CLI, before any data is read: (roots,
    imgs, gts, aois, explicit_aois, dsm, conf and mask paths)."""
    roots, imgs = _split(args.root_dirs), _split(args.img_dirs)
    gts = _split(args.gt_dirs)
    if len(imgs) != len(roots):
        raise SystemExit("error: --img_dirs count must match --root_dirs")
    if gts and len(gts) != len(roots):
        raise SystemExit("error: --gt_dirs count must match --root_dirs")
    explicit_aois = _split(args.aoi_ids)
    if explicit_aois and len(explicit_aois) != len(roots):
        raise SystemExit("error: --aoi_ids count must match --root_dirs")
    aois = explicit_aois or [os.path.basename(os.path.normpath(r)) for r in roots]
    if len(set(aois)) != len(aois):
        raise SystemExit(f"error: duplicate AOI run names {aois}; disambiguate with --aoi_ids")
    n = len(roots)
    return dict(roots=roots, imgs=imgs, gts=gts, aois=aois, explicit_aois=bool(explicit_aois),
                dsm_paths=_split_keep(args.init_dsm_paths, n, "--init_dsm_paths"),
                conf_paths=_split_keep(args.init_conf_paths, n, "--init_conf_paths"),
                mask_dirs=_split_keep(args.shadow_masks_dirs, n, "--shadow_masks_dirs"))


def mesh_axes(args, n_scenes, device):
    """(scene axis, data axis) by the JAX rule over the visible cards (one
    on the CPU, and under ``"cuda:K"``, where every rank shares card K)."""
    dev = torch.device(device)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" and dev.index is None else 1
    scene_ax = args.scene_axis or (n_scenes if n_dev % n_scenes == 0 else 1)
    data_ax = args.data_axis or max(n_dev // scene_ax, 1)
    return scene_ax, data_ax


def main_multi_train(argv=None, device="cuda"):
    """Train S scenes from the command line on ``device`` (the card, one a
    rank; "cpu" runs every rank on the CPU, gloo between them). Prints and
    returns the stats of the mesh's rank 0 (None on the other ranks under
    ``torchrun``)."""
    from eonerf_code_tpu_torch.parallel import mesh as pmesh

    args = parse_args(argv)
    plan = _plan(args)
    n_scenes = len(plan["roots"])
    scene_ax, data_ax = mesh_axes(args, n_scenes, device)
    print(f"mesh: scene={scene_ax} x data={data_ax} over "
          f"{pmesh.resolve_world(data_ax, device, scene_ax)} processes; {n_scenes} scenes",
          flush=True)
    if args.use_pallas == "auto":
        # TrainConfig.use_pallas=None's rule (models/fused.py), resolved here
        # so that opts.json records what ran
        use_pallas = (args.compute_dtype == "bfloat16" and torch.device(device).type == "cuda"
                      and args.fc_layers == 8 and args.fc_units == 256)
    else:
        use_pallas = args.use_pallas == "true"
    stats = pmesh.launch(_train, {"args": args, "plan": plan, "use_pallas": use_pallas,
                                  "axes": (scene_ax, data_ax)},
                         data_ax, device, scene_axis=scene_ax).get(0)
    if stats is not None:
        print(stats)
    return stats


def _resolve_sampler(args, datasets, n_scenes, root):
    """(sampler, n_samples, n_importance): the single-AOI rules over the
    WORST scene. An explicit --n_importance wins (hierarchical); auto picks
    tightening only when every scene's altitude envelope is compact, else
    hierarchical for all; hierarchical without a count takes 3/4 of the
    samples coarse and half of those fine."""
    from eonerf_code_tpu_torch.config import TrainConfig

    sampler = args.sampler
    n_samples, n_importance = args.n_samples, args.n_importance
    if n_importance > 0:
        sampler = "hierarchical"
    elif sampler == "auto":
        widest = max(hi - lo for lo, hi in (d.alt_envelope() for d in datasets))
        sampler = ("tighten" if widest <= TrainConfig().occ_tighten_max_envelope_m
                   else "hierarchical")
        if root:
            print(f"sampler=auto -> {sampler} (widest envelope {widest:.0f} m over "
                  f"{n_scenes} scenes)", flush=True)
    if sampler == "hierarchical" and n_importance == 0:
        n_samples = max((3 * n_samples) // 4, 8)
        n_importance = max(n_samples // 2, 4)
    return sampler, n_samples, n_importance


def _train(device, args, plan, use_pallas, axes):
    """One rank of :func:`main_multi_train`."""
    from eonerf_code_tpu_torch.config import TrainConfig
    from eonerf_code_tpu_torch.data.satellite import SatelliteDataset
    from eonerf_code_tpu_torch.parallel import mesh as pmesh
    from eonerf_code_tpu_torch.parallel.multi_aoi import MultiAOITrainer, unstack_params
    from eonerf_code_tpu_torch.train.checkpoints import latest_checkpoint, save_checkpoint
    from eonerf_code_tpu_torch.train.loop import OCC_SIDECAR
    from eonerf_code_tpu_torch.utils.tb import MetricsLogger

    scene_ax, data_ax = axes
    mesh = pmesh.current(data_ax, device, scene_axis=scene_ax)
    root = mesh.is_root
    roots, imgs, gts, aois = plan["roots"], plan["imgs"], plan["gts"], plan["aois"]
    n_scenes = len(roots)
    datasets = [SatelliteDataset(r, i, split="train", prior_dsm_path=dp, prior_conf_path=cp,
                                 shadow_masks_dir=md)
                for r, i, dp, cp, md in zip(roots, imgs, plan["dsm_paths"], plan["conf_paths"],
                                            plan["mask_dirs"])]
    sampler, n_samples, n_importance = _resolve_sampler(args, datasets, n_scenes, root)
    occ_tighten = sampler == "tighten"
    sc_n = TrainConfig(n_samples=n_samples, sc_n_samples=args.sc_n_samples).resolve_sc_n_samples()
    if args.rpc_correction and args.freq_reg_end_step <= 0 and root:
        print("warning: --rpc_correction without --freq_reg_end_step: joint camera refinement "
              "usually needs coarse-to-fine PE annealing to converge (see "
              "train_eonerf_torch.py's warning)", file=sys.stderr)

    tr = MultiAOITrainer(datasets, mesh, n_samples=n_samples, sc_n_samples=sc_n,
                         n_importance=n_importance, occ_enabled=occ_tighten,
                         occ_tighten=occ_tighten,
                         occ_tighten_start_step=args.occ_tighten_start_step,
                         n_grid=args.n_grid, rpc_correction=args.rpc_correction,
                         batch_size=args.batch_size, lr=args.lr,
                         lr_decay_steps=args.lr_decay_steps, net_depth=args.fc_layers,
                         net_width=args.fc_units, seed=args.seed,
                         compute_dtype=args.compute_dtype, use_pallas=use_pallas,
                         bwd_acts=args.bwd_acts, freq_reg_start_step=args.freq_reg_start_step,
                         freq_reg_end_step=args.freq_reg_end_step)
    del datasets
    # the shadow gate: the single-AOI epoch-2 rule on the smallest pool
    if args.first_shadow_step is None:
        first_shadow = 2 * max(int(tr.n_rays_per_scene.min()) // args.batch_size, 1)
    else:
        first_shadow = args.first_shadow_step

    exp_dir = os.path.join(args.logs_dir, args.exp_name)
    pod_dir = os.path.join(exp_dir, "_pod")
    if args.resume:
        latest = latest_checkpoint(pod_dir)
        if latest is not None:
            tr.restore_pod(latest)
            if root:
                print(f"resumed pod from {latest} (step {tr.step})", flush=True)
    loggers = [MetricsLogger(os.path.join(exp_dir, a)) for a in aois] if root else []

    t0 = time.time()
    done = start_step = tr.step
    while done < args.max_train_steps:
        shadows = done >= first_shadow
        until = args.max_train_steps if shadows else min(first_shadow, args.max_train_steps)
        n = min(args.log_every, until - done)
        if args.save_freq > 0:
            r = done % args.save_freq
            n = min(n, args.save_freq - r if r else args.save_freq)
        losses = tr.train_steps(n, shadows=shadows)
        done += n
        if args.save_freq > 0 and done % args.save_freq == 0 and done < args.max_train_steps:
            tr.save_pod(pod_dir)
        vals = losses.numpy()
        for lg, v in zip(loggers, vals):
            lg.scalar("train/loss", float(v), done)
        if root:
            print(f"step {done}/{args.max_train_steps} shadows={shadows} "
                  f"losses={[round(float(v), 4) for v in vals]}", flush=True)

    if tr.device.type == "cuda":
        torch.cuda.synchronize(tr.device)
    elapsed = time.time() - t0
    # the final pod checkpoint: a later --resume with more steps extends the
    # run from here
    state = tr.state_pytree()
    tr.save_pod(pod_dir, state)
    if root:
        # one run dir per scene, in the single-AOI contract
        tighten_active = tr.occ_gate_open()
        params = unstack_params(state["params"], n_scenes)
        for i, (aoi, rdir, img) in enumerate(zip(aois, roots, imgs)):
            cfg = TrainConfig(
                root_dir=rdir, img_dir=img, gt_dir=(gts[i] if gts else None),
                # explicit --aoi_ids are the data's AOI ids (eval resolves
                # the GT as <aoi_id>_DSM.tif); without them eval infers it
                logs_dir=exp_dir, exp_name=aoi,
                aoi_id=(aoi if plan["explicit_aois"] else None),
                batch_size=args.batch_size, max_train_steps=args.max_train_steps,
                n_samples=n_samples, n_importance=n_importance, sc_n_samples=sc_n,
                sampler=sampler, net_depth=args.fc_layers, net_width=args.fc_units, lr=args.lr,
                lr_decay_steps=args.lr_decay_steps, seed=args.seed,
                compute_dtype=args.compute_dtype, rpc_correction=args.rpc_correction,
                init_dsm_path=plan["dsm_paths"][i], init_conf_path=plan["conf_paths"][i],
                shadow_masks_dir=plan["mask_dirs"][i],
                freq_reg_start_step=args.freq_reg_start_step,
                freq_reg_end_step=args.freq_reg_end_step, occ_enabled=occ_tighten,
                occ_tighten=occ_tighten, occ_tighten_start_step=args.occ_tighten_start_step,
                n_grid=args.n_grid, use_pallas=use_pallas, bwd_acts=args.bwd_acts)
            run_dir = cfg.log_dir()
            cfg.save(os.path.join(run_dir, "opts.json"))
            scene_state = {"params": params[i], "step": args.max_train_steps}
            sidecars = {}
            if "occ" in state:
                scene_state["occ"] = {k: v[i] for k, v in state["occ"].items()}
            if occ_tighten:
                # the single-AOI sidecar's keys: eval knows whether tightened
                # sampling was on at this checkpoint
                sidecars[OCC_SIDECAR] = {"tighten_active": tighten_active,
                                         "frac_hist": [float(h[i]) for h in tr._occ_frac_hist]}
            save_checkpoint(run_dir, args.max_train_steps, scene_state, sidecars=sidecars)
            loggers[i].close()
    mesh.barrier()

    # throughput over the steps this process ran (0.0 when the run was
    # already complete)
    steps_run = done - start_step
    rays = n_scenes * args.batch_size * steps_run
    return {"steps": args.max_train_steps, "steps_run": steps_run, "scenes": n_scenes,
            "elapsed_s": elapsed,
            "rays_per_sec": (rays / max(elapsed, 1e-9)) if steps_run else 0.0,
            "run_dirs": [os.path.join(exp_dir, a) for a in aois]}
