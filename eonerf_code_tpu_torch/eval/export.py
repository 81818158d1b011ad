"""Export bundle-adjusted cameras from a trained run (the JAX package's
eval/export.py).

A run trained with ``rpc_correction`` learns per-image translations of the
ray bundle in the normalized scene frame (``EONerfField.ray_correction_enc``;
the reference declares --rpc_correction but never wires it). Downstream
photogrammetry needs them folded back into the camera model: for each train
view this writes the original metadata with the RPC's col/row offsets
corrected (geo/bundle_adjust.py), and the applied image-space shift under
``rpc_adjustment_px``.
"""

import os

import numpy as np

from eonerf_code_tpu_torch.data.satellite import SatelliteDataset, read_json, write_json
from eonerf_code_tpu_torch.eval.run import load_checkpoint
from eonerf_code_tpu_torch.geo.bundle_adjust import rpc_offset_from_scene_offset


def export_adjusted_rpcs(run_dir, output_dir, epoch_nb=None, root_dir=None, img_dir=None):
    """Write bundle-adjusted RPC metadata for every train view of a run into
    ``output_dir``; returns {img_id: {"path", "d_col", "d_row"}}. Raises
    ``ValueError`` for a run trained without ``rpc_correction``."""
    cfg, _, state = load_checkpoint(run_dir, epoch_nb)
    if root_dir:
        cfg.root_dir = root_dir
    if img_dir:
        cfg.img_dir = img_dir
    if cfg.cache_dir and not os.path.isdir(cfg.cache_dir):
        cfg.cache_dir = None

    offsets = state["params"].get("ray_correction_enc.weight")
    if offsets is None:
        raise ValueError(f"run {run_dir} was trained without --rpc_correction: "
                         "no bundle-adjustment offsets in the checkpoint")
    offsets = offsets.double().numpy()

    ds = SatelliteDataset(cfg.root_dir, cfg.img_dir, split="train",
                          img_downscale=cfg.img_downscale, utm=not cfg.ecef,
                          cache_dir=cfg.cache_dir, subset=cfg.subset_n_views)
    zonestring = ds.scene.utm_zonestring
    south = zonestring[-1] < "N"
    # the dataset's RPCs are rescaled by img_downscale, and so is the shift:
    # the metadata is exported at its native scale
    scale = cfg.img_downscale if cfg.img_downscale else 1.0
    os.makedirs(output_dir, exist_ok=True)
    out = {}
    for i, json_path in enumerate(ds.json_files):
        meta = read_json(json_path)
        d_col, d_row = rpc_offset_from_scene_offset(
            ds.all_rpcs[i], offsets[i], ds.scene.scene_scale, ds.scene.scene_offset, zonestring,
            south=south)
        native = dict(meta["rpc"])
        native["col_offset"] = native["col_offset"] - d_col * scale
        native["row_offset"] = native["row_offset"] - d_row * scale
        meta_out = dict(meta)
        meta_out["rpc"] = native
        meta_out["rpc_adjustment_px"] = {
            "d_col": float(d_col * scale), "d_row": float(d_row * scale),
            "working_scale_d_col": float(d_col), "working_scale_d_row": float(d_row)}
        img_id = os.path.splitext(os.path.basename(json_path))[0]
        path = os.path.join(output_dir, img_id + ".json")
        write_json(meta_out, path)
        out[img_id] = {"path": path, "d_col": float(d_col * scale),
                       "d_row": float(d_row * scale)}
    return out
