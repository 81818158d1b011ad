"""The eval run: a finished training run's DSM and registered altitude MAE,
or its per-view photometric report (the JAX package's eval/run.py; the
reference's eval_eonerf.py:251-381).

``eval_eonerf`` reloads ``opts.json`` and a checkpoint (``load_run``, and
the occupancy grid when the run sampled through it, ``load_occ_grid``),
then either

- ``dsm=True``: renders a virtual nadir camera (orthographic, or pinhole)
  over the scene cube with the sun of the most-nadir view, writes the
  outputs as GeoTIFFs, extracts the georeferenced DSM, registers it against
  the lidar GT and returns the MAE; or
- ``dsm=False``: renders every train and test view and returns each one's
  beta loss and PSNR.

On the card a bfloat16 8x256 run renders through the fused camera and
shadow kernels (``make_render_field``), as it trained; the renders are
perturbed as the reference's are, from a generator seeded 0 for each
``render_image`` call. A checkpoint inside the coarse-to-fine ramp renders
through its step's PE mask (``load_run``). ``data_axis`` renders over the
ranks of a data axis (``render_image_sharded``), the files written on rank
0 alone.
"""

import json
import os
import shutil

import numpy as np
import torch

from eonerf_code_tpu_torch.config import TrainConfig
from eonerf_code_tpu_torch.data.rays import satrays_from_tensor
from eonerf_code_tpu_torch.data.satellite import SatelliteDataset, get_file_id, read_json
from eonerf_code_tpu_torch.data.views import sort_by_increasing_view_incidence_angle
from eonerf_code_tpu_torch.eval.dsm import compute_mae_and_save_dsm_diff
from eonerf_code_tpu_torch.io.image import save_image_like
from eonerf_code_tpu_torch.models.eonerf import EONerfField
from eonerf_code_tpu_torch.models.freq_reg import pe_masked, step_pe_mask
from eonerf_code_tpu_torch.models.fused import make_render_field
from eonerf_code_tpu_torch.ops.occupancy import OccupancyGrid
from eonerf_code_tpu_torch.parallel import mesh as pmesh
from eonerf_code_tpu_torch.render.nadir import enu_frame, nadir_rays_with_sun
from eonerf_code_tpu_torch.render.satellite import (
    RenderConfig,
    render_image,
    render_image_sharded,
)
from eonerf_code_tpu_torch.train import checkpoints as ckpt_lib
from eonerf_code_tpu_torch.train.loop import OCC_SIDECAR
from eonerf_code_tpu_torch.utils import metrics as M


def load_checkpoint(run_dir, epoch_nb=None):
    """(cfg, checkpoint directory, state on the CPU) of a training run:
    ``ckpts/epoch=<epoch_nb>``, or the latest integer epoch."""
    opts_path = os.path.join(run_dir, "opts.json")
    if not os.path.exists(opts_path):
        raise SystemExit(f"error: no training run at '{run_dir}' (missing {opts_path}); "
                         "check the run id and --logs_dir")
    cfg = TrainConfig.load(opts_path)
    path = (os.path.join(run_dir, "ckpts", f"epoch={epoch_nb}") if epoch_nb is not None
            else ckpt_lib.latest_checkpoint(run_dir))
    if path is None or not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint under {run_dir}"
                                + ("" if epoch_nb is None else f" for epoch {epoch_nb}"))
    return cfg, path, ckpt_lib.restore_checkpoint(path, map_location="cpu")


def load_run(run_dir, epoch_nb=None, n_images=None, device="cuda"):
    """(cfg, render field, EONerfField) of a training run on ``device``; the
    render field is what the trainer rendered through (``KernelField`` for a
    bfloat16 8x256 field on the card, by ``cfg.use_pallas``). A checkpoint
    saved inside the coarse-to-fine ramp trained through its step's PE mask
    (the masked trunk rows still hold their random initial values), so its
    render field carries that mask, as the trainer's ``_reg_field`` at that
    step (the JAX package's ``load_run``); the EONerfField keeps the raw
    parameters."""
    cfg, _, state = load_checkpoint(run_dir, epoch_nb)
    params = state["params"]
    if n_images is None:
        train_txt = os.path.join(cfg.root_dir, "train.txt")
        if os.path.exists(train_txt):
            with open(train_txt) as f:
                n_images = len([x for x in f.read().split("\n") if ".json" in x])
            if cfg.subset_n_views is not None and cfg.subset_n_views > 1:
                n_images = min(n_images, cfg.subset_n_views)
    # the checkpoint's embedding table wins (the reference warns and takes
    # its shape, eval_eonerf.py:52-56)
    n_in_ckpt = params["transient_encoder.weight"].shape[0]
    if n_images is not None and n_images != n_in_ckpt:
        print("warning: number of input images is inconsistent with the "
              f"shape of the embedding dictionary ({n_images} vs {n_in_ckpt})")
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    field = EONerfField(n_in_ckpt, net_depth=cfg.net_depth, net_width=cfg.net_width,
                        radiometric_normalization=cfg.radiometric_normalization,
                        rpc_correction=cfg.rpc_correction, compute_dtype=dtype, device=device,
                        generator=torch.Generator().manual_seed(0))
    field.load_state_dict(params)
    render_field = make_render_field(field, cfg)
    step = int(state.get("step", cfg.freq_reg_end_step))
    if step < cfg.freq_reg_end_step:
        render_field = pe_masked(render_field,
                                 step_pe_mask(cfg, step, field.pos_enc_deg, device))
    return cfg, render_field, field


def load_occ_grid(run_dir, cfg, epoch_nb=None, device="cuda"):
    """The checkpoint's occupancy grid when the run sampled through it, else
    None: only with ``occ_tighten``, and only when the gate was open at the
    checkpoint (an early or never-stable checkpoint trained untightened, so
    eval does not tighten either). The verdict is the sidecar's
    ``tighten_active``, else the checkpoint's own gate; a checkpoint with
    neither counts as open."""
    if not cfg.occ_tighten:
        return None
    _, path, state = load_checkpoint(run_dir, epoch_nb)
    sidecar = os.path.join(path, OCC_SIDECAR)
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            active = json.load(f).get("tighten_active", True)
    else:
        active = state.get("gate", {}).get("tighten_active", True)
    if not active or "occ" not in state:
        return None
    return OccupancyGrid(occs=state["occ"]["occs"].to(device),
                         binaries=state["occ"]["binaries"].to(device), resolution=cfg.n_grid)


def _np(x):
    return x.float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_outputs_to_images(dataset, sample, results, out_dir, suffix=""):
    """The rendered rasters, the GT rgb and the depth and DSM GeoTIFFs of one
    view (reference datasets/satellite.py:195-239)."""
    src_id = sample["src_id"]
    src_path = os.path.join(dataset.img_dir, src_id + ".tif")
    h, w = sample["h"], sample["w"]

    def out(key):
        return os.path.join(out_dir, key, f"{src_id}{suffix}.tif")

    for k in ("geo_shadows", "transient_s", "beta"):
        if k in results:
            save_image_like(out(k), _np(results[k]).reshape(1, h, w).repeat(3, 0), src_path)
    for k in ("rgb", "ambient_rgb", "albedo_rgb"):
        if k in results:
            save_image_like(out(k), _np(results[k]).reshape(h, w, 3).transpose(2, 0, 1),
                            src_path)
    save_image_like(out("gt_rgb"), np.asarray(sample["rgbs"]).reshape(h, w, 3).transpose(2, 0, 1),
                    src_path)
    if "depth" in results:
        depth = _np(results["depth"])
        _, _, alts = dataset.utmalt_from_depth(sample["rays"], depth)
        save_image_like(out("depth"), np.asarray(alts, np.float32).reshape(1, h, w), src_path)
        dataset.dsm_from_depth(sample["rays"], depth, dsm_path=out("dsm"),
                               resolution=0.5 if "JAX" in src_id else 0.3)


def save_depth_priors_img(dataset, sample, external_dsm_path, out_dir, external_conf_path=None,
                          suffix=""):
    """The depth prior, DSM prior and confidence rasters an external DSM
    gives one view (reference datasets/satellite.py:241-264)."""
    src_id = sample["src_id"]
    src_path = os.path.join(dataset.img_dir, src_id + ".tif")
    h, w = sample["h"], sample["w"]
    json_path = os.path.join(dataset.scene.root_dir, src_id + ".json")
    depth, conf = dataset.load_depth_priors_from_dsm(external_dsm_path, external_conf_path,
                                                     json_files=[json_path])
    _, _, alts = dataset.utmalt_from_depth(sample["rays"], depth)
    alts = np.asarray(alts, np.float32)
    alts[depth < 0.0] = np.nan
    save_image_like(os.path.join(out_dir, "depth_prior", f"{src_id}{suffix}.tif"),
                    alts.reshape(1, h, w), src_path)
    dataset.dsm_from_depth(sample["rays"], depth,
                           dsm_path=os.path.join(out_dir, "dsm_prior", f"{src_id}{suffix}.tif"),
                           resolution=0.5 if "JAX" in src_id else 0.3)
    if conf is not None:
        conf = np.asarray(conf, np.float32).copy()
        conf[conf < 0.0] = np.nan
        save_image_like(os.path.join(out_dir, "conf_prior", f"{src_id}{suffix}.tif"),
                        conf.reshape(1, h, w), src_path)


def eval_eonerf(run_id, logs_dir, output_dir, epoch_nb=None, root_dir=None, img_dir=None,
                gt_dir=None, dsm=False, chunk=4096, dsm_resolution=None, pinhole=False,
                data_axis=0, nadir_frame="auto", device="cuda"):
    """Evaluate run ``logs_dir/run_id`` into ``output_dir/run_id`` on
    ``device``. ``dsm``: {"mae", "dsm_path", "rdsm_path"} ({"dsm_path"}
    without a ``gt_dir``); else a list of {"src_id", "loss", "psnr"}, one a
    train and test view. ``dsm_resolution`` rasterizes the DSM on another
    grid than the reference's 0.3 m (0.5 m for JAX AOIs). An ECEF run
    sweeps in the local ENU frame of the scene centre unless ``nadir_frame``
    is "zup" (the reference's z-up construction).

    ``data_axis`` as the JAX package's: 0 or 1 renders on one device, -1
    over every visible card, N over N ranks (one a card under
    ``device="cuda"``; ``"cuda:K"`` shares card K over gloo).
    Outside a process group the ranks are started here
    (``parallel.mesh.launch``) and rank 0's result is returned. Every rank
    renders its run of each sweep's blocks; rank 0 alone writes the
    GeoTIFFs, the DSM and its registration and returns the result (the
    other ranks return None)."""
    axis = 1 if data_axis in (0, 1) else data_axis
    if (axis != 1 and not torch.distributed.is_initialized()
            and pmesh.resolve_world(axis, device) > 1):
        kwargs = dict(run_id=run_id, logs_dir=logs_dir, output_dir=output_dir,
                      epoch_nb=epoch_nb, root_dir=root_dir, img_dir=img_dir, gt_dir=gt_dir,
                      dsm=dsm, chunk=chunk, dsm_resolution=dsm_resolution, pinhole=pinhole,
                      data_axis=data_axis, nadir_frame=nadir_frame)
        return pmesh.launch(eval_eonerf, kwargs, axis, device).get(0)
    mesh = pmesh.current(axis, device)
    main = mesh.is_main
    run_dir = os.path.join(logs_dir, run_id)
    dev = torch.device(device)
    cfg, field, _ = load_run(run_dir, epoch_nb, device=dev)
    if root_dir:
        cfg.root_dir = root_dir
    if img_dir:
        cfg.img_dir = img_dir
    if gt_dir:
        cfg.gt_dir = gt_dir
    if cfg.cache_dir and not os.path.isdir(cfg.cache_dir):
        cfg.cache_dir = None

    with mesh.main_first():
        dataset = SatelliteDataset(cfg.root_dir, cfg.img_dir, split="val",
                                   img_downscale=cfg.img_downscale, utm=not cfg.ecef,
                                   cache_dir=cfg.cache_dir)
    # every view of the train and test rosters (eval_eonerf.py:269-276)
    files = dataset.scene._split_files("train.txt")
    if os.path.exists(os.path.join(cfg.root_dir, "test.txt")):
        files = files + dataset.scene._split_files("test.txt")
    dataset.json_files = [os.path.join(cfg.root_dir, p) for p in files]
    dataset.all_ids_img = list(range(len(files)))

    rcfg = RenderConfig(n_samples=cfg.n_samples, sc_n_samples=cfg.resolve_sc_n_samples(),
                        n_importance=cfg.n_importance, occ_tighten=cfg.occ_tighten,
                        occ_tighten_shadows=cfg.resolved_occ_tighten_shadows(),
                        occ_explore_frac=0.0)
    occ_grid = load_occ_grid(run_dir, cfg, epoch_nb, device=dev)
    out_dir = os.path.join(output_dir, run_id)

    def render(rays_np, ts):
        rays = satrays_from_tensor(torch.as_tensor(rays_np).to(dev, torch.float32),
                                   torch.as_tensor(ts).to(dev))
        generator = torch.Generator(device=dev).manual_seed(0)
        if mesh.distributed:
            return render_image_sharded(field, rays, rcfg, True, mesh, chunk=chunk,
                                        generator=generator, occ_grid=occ_grid)
        return render_image(field, rays, rcfg, True, chunk=chunk, generator=generator,
                            occ_grid=occ_grid)

    if dsm:
        nadir_json = sort_by_increasing_view_incidence_angle(dataset.scene.root_dir)[0]
        d = read_json(nadir_json)
        src_id = get_file_id(nadir_json)
        frame = None
        if cfg.ecef and nadir_frame != "zup":
            frame = enu_frame(dataset.scene.scene_offset)
        rays_np, h, w = nadir_rays_with_sun(
            int(d["width"]), int(d["height"]), 90.0 - float(d["sun_elevation"]),
            float(d["sun_azimuth"]), dataset.scene.scene_scale, img_downscale=cfg.img_downscale,
            pinhole=pinhole, frame=frame)
        results = render(rays_np, np.zeros((rays_np.shape[0],), np.int32))
        if not main:
            return None
        sample = {"rays": rays_np, "rgbs": np.ones((rays_np.shape[0], 3), np.float32),
                  "src_id": src_id, "h": h, "w": w}
        save_outputs_to_images(dataset, sample, results, out_dir)

        dsm_path = os.path.join(out_dir, "dsm", f"{src_id}.tif")
        if dsm_resolution is not None:
            dataset.dsm_from_depth(rays_np, _np(results["depth"]), dsm_path=dsm_path,
                                   resolution=dsm_resolution)
        if not os.path.exists(dsm_path):
            raise FileNotFoundError(f"the DSM {dsm_path} was not written")
        if cfg.gt_dir is None:
            return {"dsm_path": dsm_path}

        aoi_id = cfg.aoi_id or (src_id[:7] if "JAX" in src_id
                                else os.path.basename(cfg.root_dir.rstrip("/")).replace("_new", ""))
        epoch_tag = epoch_nb if epoch_nb is not None else "final"
        mae = compute_mae_and_save_dsm_diff(dsm_path, src_id, cfg.gt_dir, out_dir, epoch_tag,
                                            aoi_id)
        tmp = os.path.join(out_dir, f"{src_id}_rdsm_epoch{epoch_tag}.tif")
        final = tmp.replace(".tif", f"_{mae:.3f}.tif")
        if os.path.exists(tmp):
            shutil.move(tmp, final)
        return {"mae": mae, "dsm_path": dsm_path, "rdsm_path": final}

    report = []
    for i in range(len(dataset.json_files)):
        sample = dataset.get_val_sample(i)
        results = render(sample["rays"], sample["ts"])
        if not main:
            continue
        rgbs = torch.as_tensor(sample["rgbs"]).to(dev, torch.float32)
        loss, _ = M.uncertainty_aware_loss(rgbs, results["rgb"], results["beta"])
        psnr = M.psnr(results["rgb"], rgbs)
        save_outputs_to_images(dataset, sample, results, out_dir)
        report.append({"src_id": sample["src_id"], "loss": float(loss), "psnr": float(psnr)})
    return report if main else None
