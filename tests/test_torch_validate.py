"""Validation inside the port's trainer against the JAX package's Trainer,
and the ``occ_sampling.json`` sidecar. Each package generates its own copy
of one scene (2 train views, 1 test view, 24 x 24; GT at 2 m) and builds
its Trainer from it: a 2 x 32 field, 16 camera and 16 shadow samples,
shadows and the beta loss from step 0, the JAX weights carried into the
port (``interop/jax_params.py``) and both trainers' ``rcfg_eval`` without
jitter (the two frameworks' random numbers differ). No field is trained.

Tolerances: ``render_view`` within 1e-5; a DSM MAE from one depth array
through both packages' device and host paths with the same registration
shift and within 1 cm; ``validate()``'s logged loss and PSNR within 1e-4
relative and its MAE within 1 cm (the JAX registration on its numpy
search, ``use_native=False``, as the port has no native library)."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from eonerf_code_tpu.config import TrainConfig as JaxConfig
from eonerf_code_tpu.data import synthetic as jsyn
from eonerf_code_tpu.eval import device as jdev
from eonerf_code_tpu.eval import dsm as jdsm
from eonerf_code_tpu.eval import registration as jreg
from eonerf_code_tpu.train import loop as jloop
from eonerf_code_tpu_torch.config import TrainConfig
from eonerf_code_tpu_torch.data import synthetic as tsyn
from eonerf_code_tpu_torch.eval import device as tdev
from eonerf_code_tpu_torch.eval import dsm as tdsm
from eonerf_code_tpu_torch.interop.jax_params import field_state_from_jax
from eonerf_code_tpu_torch.train import checkpoints as ckpt_lib
from eonerf_code_tpu_torch.train import loop as tloop

RENDER_TOL = 1e-5
METRIC_RTOL = 1e-4
MAE_TOL_M = 0.01
SIZE = 24
CFG = dict(net_depth=2, net_width=32, n_samples=16, sc_n_samples=16, sampler="uniform",
           occ_enabled=False, batch_size=128, first_shadow_step=0, first_beta_step=0,
           chunk=256, n_val_images=5, seed=3)
_JAX_COMPUTE_NCC = jreg.compute_ncc


@pytest.fixture(autouse=True)
def numpy_search(monkeypatch):
    monkeypatch.setattr(jreg, "compute_ncc", lambda u, v, irange, dx, dy: _JAX_COMPUTE_NCC(
        u, v, irange, dx, dy, use_native=False))


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    spec = dict(n_views=2, n_test_views=1, img_size=SIZE, dsm_resolution=2.0)
    return {"jax": jsyn.generate_scene(str(tmp_path_factory.mktemp("jax_scene")),
                                       jsyn.SyntheticSceneSpec(**spec)),
            "port": tsyn.generate_scene(str(tmp_path_factory.mktemp("port_scene")),
                                        tsyn.SyntheticSceneSpec(**spec))}


def _paths(info, logs, name):
    return dict(root_dir=info["root_dir"], img_dir=info["img_dir"], gt_dir=info["gt_dir"],
                aoi_id=info["aoi_id"], logs_dir=str(logs), exp_name=name)


@pytest.fixture(scope="module")
def trainers(scenes, tmp_path_factory):
    """(port, JAX) trainers on their copies of the scene, the port carrying
    the JAX weights, both rendering without jitter."""
    logs = tmp_path_factory.mktemp("logs")
    jtr = jloop.Trainer(JaxConfig(**_paths(scenes["jax"], logs / "jax", "pair"), **CFG))
    ttr = tloop.Trainer(TrainConfig(**_paths(scenes["port"], logs / "port", "pair"), **CFG),
                        device="cpu")
    ttr.field.load_state_dict(field_state_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                          jtr.params)))
    jtr.rcfg_eval = dataclasses.replace(jtr.rcfg_eval, perturb=False)
    ttr.rcfg_eval = dataclasses.replace(ttr.rcfg_eval, perturb=False)
    return ttr, jtr


def test_render_view_matches(trainers):
    """The test view rendered whole (3 blocks of 256 rays, shadows on)."""
    ttr, jtr = trainers
    assert ttr.rcfg_eval.occ_explore_frac == 0.0 and ttr.epoch_flags(0)[0]
    sample = ttr.val_ds.get_val_sample(1)
    got, want = ttr.render_view(sample), jtr.render_view(jtr.val_ds.get_val_sample(1))
    for key in ("rgb", "depth", "beta", "geo_shadows"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0,
                                   atol=RENDER_TOL, err_msg=key)
    depth = ttr.render_view(sample, depth_only=True)
    assert list(depth) == ["depth"] and depth["depth"].shape == (SIZE * SIZE, 1)
    np.testing.assert_allclose(depth["depth"].numpy(), got["depth"].numpy(), rtol=0,
                               atol=RENDER_TOL)


def _spy(monkeypatch, module, name, record, shift_of):
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        out = fn(*args, **kwargs)
        record.append(shift_of(out))
        return out

    monkeypatch.setattr(module, name, spy)


@pytest.fixture(scope="module")
def ecef_trainers(scenes, tmp_path_factory):
    """(port, JAX) trainers of the scene's ECEF cube (no weights needed)."""
    logs = tmp_path_factory.mktemp("ecef_logs")
    return (tloop.Trainer(TrainConfig(**_paths(scenes["port"], logs / "port", "ecef"), **CFG,
                                      ecef=True), device="cpu"),
            jloop.Trainer(JaxConfig(**_paths(scenes["jax"], logs / "jax", "ecef"), **CFG,
                                    ecef=True)))


def _view_depth(ttr):
    """The GT DSM reprojected into test view 1 of the UTM cube (as a depth
    prior is), moved back along each ray by about 1.5 m of altitude, with
    seeded noise; holes filled with the median depth."""
    dsm = os.path.join(ttr.cfg.gt_dir, f"{ttr.cfg.aoi_id}_DSM.tif")
    depth, _ = ttr.train_ds.load_depth_priors_from_dsm(dsm, json_files=[ttr.val_ds.json_files[1]])
    rng = np.random.default_rng(4)
    depth = np.where(depth < 0, np.median(depth[depth >= 0]), depth)
    return depth - (1.5 + rng.normal(0, 0.2, depth.shape)) / ttr.train_ds.scene.scene_scale[2]


@pytest.mark.parametrize("frame,path", [("utm", "device"), ("utm", "host"), ("ecef", "device")])
def test_val_mae_matches(trainers, ecef_trainers, monkeypatch, frame, path):
    """One depth array through both packages' MAE paths (_view_depth; in
    the ECEF cube at the same fraction of each ray, which both frames cast
    between the same two geodetic points). The same shift first, then the
    MAE within 1 cm."""
    utm_tr = trainers[0]
    ttr, jtr = trainers if frame == "utm" else ecef_trainers
    sample = ttr.val_ds.get_val_sample(1)
    jsample = jtr.val_ds.get_val_sample(1)
    depth = _view_depth(utm_tr)
    if frame == "ecef":
        depth = depth / utm_tr.val_ds.get_val_sample(1)["rays"][:, 7] * sample["rays"][:, 7]
    depth = depth.astype(np.float32)
    shifts = {"port": [], "jax": []}
    if path == "device":
        _spy(monkeypatch, tdev, "device_dsm_mae", shifts["port"], lambda o: o[1][:2])
        _spy(monkeypatch, jdev, "device_dsm_mae", shifts["jax"],
             lambda o: (int(o[1][0]), int(o[1][1])))
        got = ttr.val_mae_device(sample, {"depth": torch.from_numpy(depth)[:, None]})
        want = jtr.val_mae_device(jsample, {"depth": depth[:, None]})
    else:
        _spy(monkeypatch, tdsm, "compute_shift_arrays", shifts["port"], lambda o: o[:2])
        _spy(monkeypatch, jdsm, "compute_shift_arrays", shifts["jax"], lambda o: o[:2])
        got = ttr._val_mae_host(sample, {"depth": torch.from_numpy(depth)[:, None]})
        want = jtr._val_mae_host(jsample, {"depth": depth[:, None]})
    assert len(shifts["port"]) == 1 and shifts["port"] == shifts["jax"], shifts
    assert np.isfinite(got) and abs(got - want) <= MAE_TOL_M, (got, want)
    assert got < 1.5     # the bias fitted: the noise and the splat at the edges are left


def _scalars(log_dir):
    out = {}
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            out.setdefault(r["tag"], []).append((r["step"], r["value"]))
    return out


def test_validate_matches(trainers):
    """validate() on the carried weights: the same val/ tags and values in
    metrics.jsonl, epoch=best with its sidecar, best_val_mae as logged."""
    ttr, jtr = trainers
    ttr.validate()
    jtr.validate()
    got, want = _scalars(ttr.log_dir), _scalars(jtr.log_dir)
    tags = sorted(t for t in want if t.startswith("val/"))
    assert sorted(t for t in got if t.startswith("val/")) == tags
    assert "val/mae_failed" not in tags and "val/device_eval_fallback" not in tags
    for tag in ("val/loss", "val/coarse_color", "val/coarse_logbeta", "val/psnr"):
        np.testing.assert_allclose(got[tag][-1][1], want[tag][-1][1], rtol=METRIC_RTOL,
                                   err_msg=tag)
    assert abs(got["val/mae"][-1][1] - want["val/mae"][-1][1]) <= MAE_TOL_M
    assert np.isfinite(ttr.best_val_mae) and ttr.best_val_mae == got["val/best_mae"][-1][1]
    best = os.path.join(ttr.log_dir, "ckpts", "epoch=best")
    with open(os.path.join(best, tloop.OCC_SIDECAR)) as f, \
            open(os.path.join(jtr.log_dir, "ckpts", "epoch=best", tloop.OCC_SIDECAR)) as g:
        side, jside = json.load(f), json.load(g)
    assert sorted(side) == sorted(jside) == ["entropy_hist", "frac_hist", "tighten_active"]
    assert side == jside
    # a second validation at no better MAE keeps the best checkpoint
    ttr.validate()
    assert ttr.best_val_mae == got["val/best_mae"][-1][1]
    assert len(_scalars(ttr.log_dir)["val/best_mae"]) == 1


def test_device_eval_modes(scenes, tmp_path, monkeypatch):
    """device_eval None: the device MAE, the host one when the device path
    fails, logged as val/device_eval_fallback; True: the failure raises
    (validate() logs val/mae_failed); False: the host path alone."""
    ttr = tloop.Trainer(TrainConfig(**_paths(scenes["port"], tmp_path, "modes"), **CFG),
                        device="cpu")
    sample = ttr.val_ds.get_val_sample(1)
    out = {"depth": torch.from_numpy(_view_depth(ttr).astype(np.float32))[:, None]}
    host = ttr._val_mae_host(sample, out)
    assert ttr._val_mae(sample, out) == ttr.val_mae_device(sample, out) != host

    def broken(*args):
        raise RuntimeError("no GT grid")

    monkeypatch.setattr(ttr, "val_mae_device", broken)
    before = _scalars(ttr.log_dir)
    assert ttr._val_mae(sample, out) == host
    assert len(_scalars(ttr.log_dir)["val/device_eval_fallback"]) == 1
    monkeypatch.setattr(ttr.cfg, "device_eval", False)
    assert ttr._val_mae(sample, out) == host
    monkeypatch.setattr(ttr.cfg, "device_eval", True)
    with pytest.raises(RuntimeError, match="no GT grid"):
        ttr._val_mae(sample, out)
    monkeypatch.setattr(ttr, "render_view", lambda s: {
        k: torch.zeros(s["rays"].shape[0], 3 if k in ("rgb", "albedo_rgb") else 1) + 0.5
        for k in ("rgb", "albedo_rgb", "geo_shadows", "depth", "beta")})
    ttr.validate()
    after = _scalars(ttr.log_dir)
    assert len(after["val/mae_failed"]) == 1 and "val/mae_failed" not in before
    assert "val/mae" not in after and "val/loss" in after
    assert not os.path.exists(os.path.join(ttr.log_dir, "ckpts", "epoch=best"))


def test_run_validates_at_multiples_of_val_freq(scenes, tmp_path, monkeypatch):
    """run() validates after steps 2, 4 and 6 of 7 (0-based), after the
    checkpoint of the same step (save_freq 4); a trainer over a caller's
    pool has no val split and never validates."""
    cfg = TrainConfig(**_paths(scenes["port"], tmp_path, "cadence"),
                      **{**CFG, "val_freq": 2, "batch_size": 64})
    tr = tloop.Trainer(cfg, device="cpu")
    assert (tr.val_freq, tr.save_freq) == (2, 8)
    tr.save_freq = 4
    events = []
    monkeypatch.setattr(tr, "validate", lambda: events.append(("val", tr.step - 1)))
    monkeypatch.setattr(tr, "save", lambda: events.append(("save", tr.step - 1)))
    tr.run(max_steps=7)
    assert events == [("val", 2), ("save", 4), ("val", 4), ("val", 6), ("save", 6)]
    cfg_p = TrainConfig(logs_dir=str(tmp_path), exp_name="pool", **{**CFG, "val_freq": 1})
    pool = {"rays": tr.device_data["rays"][:256].numpy(), "rgbs": tr.device_data["rgbs"][:256],
            "ts": tr.device_data["ts"][:256]}
    tp = tloop.Trainer(cfg_p, pool, n_images=2, device="cpu")
    assert tp.val_ds is None and tp.val_freq == 1
    monkeypatch.setattr(tp, "validate", lambda: pytest.fail("validated without a val split"))
    tp.run(max_steps=3)


def _occ_trainer(tmp_path, name, **kw):
    rng = np.random.default_rng(1)
    n = 48
    rays = np.zeros((n, 11), np.float32)
    rays[:, 0:2] = rng.uniform(-0.7, 0.7, (n, 2))
    rays[:, 2], rays[:, 5], rays[:, 7] = 0.99, -1.0, 2.0
    rays[:, 8:11] = np.array([0.3, 0.2, -0.93]) / np.linalg.norm([0.3, 0.2, -0.93])
    pool = {"rays": rays, "rgbs": rng.random((n, 3)).astype(np.float32),
            "ts": rng.integers(0, 2, n)}
    cfg = TrainConfig(logs_dir=str(tmp_path), exp_name=name, net_depth=2, net_width=32,
                      n_samples=8, sc_n_samples=8, batch_size=8, sampler="uniform",
                      occ_enabled=True, n_grid=16, occ_tighten=True, occ_tighten_start_step=1,
                      bwd_acts="recompute", **kw)
    return tloop.Trainer(cfg, pool, n_images=2, device="cpu")


@pytest.mark.parametrize("gate_open", [False, True])
def test_sidecar_holds_the_gate_state(tmp_path, gate_open):
    """save() writes {frac_hist, entropy_hist, tighten_active} beside
    state.pt; tighten_active is whether the sampler takes the grid."""
    tr = _occ_trainer(tmp_path, "side")
    tr.run(max_steps=2)
    tr._occ_frac_hist = [0.9375, 0.875, 0.75] + [0.5] * 6 if gate_open else [0.5, 0.25]
    tr._entropy_hist = [0.25]
    path = tr.save(epoch_tag="tag")
    with open(os.path.join(path, tloop.OCC_SIDECAR)) as f:
        side = json.load(f)
    assert side == {"frac_hist": tr._occ_frac_hist, "entropy_hist": [0.25],
                    "tighten_active": gate_open}
    assert (tr._occ_for_sampling() is not None) == gate_open


def test_resume_without_the_sidecar_samples_as_with_it(tmp_path):
    """As the JAX package's test_gate_state_is_self_contained_in_checkpoint:
    a gate-open checkpoint resumed with and without its sidecar restores the
    same history and samples tightened; the sidecar, when there, is what is
    read."""
    tr = _occ_trainer(tmp_path, "run")
    tr.run(max_steps=2)
    tr._occ_frac_hist = [0.9375, 0.875, 0.75] + [0.5] * 6
    tr._entropy_hist = [0.25]
    path = tr.save(epoch_tag="gateopen")
    with_side = _occ_trainer(tmp_path, "r1", ckpt_path=path)
    os.remove(os.path.join(path, tloop.OCC_SIDECAR))
    without = _occ_trainer(tmp_path, "r2", ckpt_path=path)
    for t in (with_side, without):
        assert t._occ_frac_hist == tr._occ_frac_hist and t._entropy_hist == [0.25]
        assert t._occ_for_sampling() is t.occ_grid
    # the sidecar wins over the state's lists when both are there
    with open(os.path.join(path, tloop.OCC_SIDECAR), "w") as f:
        json.dump({"frac_hist": [0.5, 0.25], "entropy_hist": [], "tighten_active": False}, f)
    side_read = _occ_trainer(tmp_path, "r3", ckpt_path=path)
    assert side_read._occ_frac_hist == [0.5, 0.25] and side_read._occ_for_sampling() is None
    assert ckpt_lib.restore_checkpoint(path)["gate"]["frac_hist"] == tr._occ_frac_hist
