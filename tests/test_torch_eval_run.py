"""The port's eval run against the JAX package's: the virtual cameras
(render/nadir.py), and ``eval_eonerf`` on the same weights, the JAX one
on a JAX run directory and the port's on that run imported by
import_jax_run.py. Each package generates its own copy of one scene (2
train views, 1 test view, 24 x 24; GT at 2 m); the field is the JAX
trainer's 2 x 32 initialisation, 16 camera and 16 shadow samples, not
trained. Both renders run without jitter (each package's
``eval.run.RenderConfig`` is patched to ``perturb=False``: the two
frameworks' random numbers differ), on the CPU.

Tolerances: cameras 1e-6; depth 1e-5; the DSM rasters the same NaN mask
and within 1e-3 m; the same registration shift, then the MAE within 1 cm
(the JAX registration on its numpy search, ``use_native=False``, as the
port has no native library); the report's loss and PSNR 1e-4 relative."""

import functools
import importlib.util
import json
import os
import pathlib
import shutil

import numpy as np
import pytest
import torch

from eonerf_code_tpu.config import TrainConfig as JaxConfig
from eonerf_code_tpu.data import synthetic as jsyn
from eonerf_code_tpu.eval import dsm as jdsm
from eonerf_code_tpu.eval import registration as jreg
from eonerf_code_tpu.eval import run as jrun
from eonerf_code_tpu.render import nadir as jnadir
from eonerf_code_tpu.train import loop as jloop
from eonerf_code_tpu_torch.data import synthetic as tsyn
from eonerf_code_tpu_torch.eval import dsm as tdsm
from eonerf_code_tpu_torch.eval import run as trun
from eonerf_code_tpu_torch.io.geotiff import GeoTiffFile
from eonerf_code_tpu_torch.models.freq_reg import PEMaskedField
from eonerf_code_tpu_torch.render import nadir as tnadir
from eonerf_code_tpu_torch.train import checkpoints as ckpt_lib

REPO = pathlib.Path(__file__).resolve().parent.parent
CAM_TOL = 1e-6
DEPTH_TOL = 1e-5
DSM_TOL_M = 1e-3
MAE_TOL_M = 0.01
METRIC_RTOL = 1e-4
SIZE = 24
CFG = dict(net_depth=2, net_width=32, n_samples=16, sc_n_samples=16, sampler="uniform",
           occ_enabled=False, batch_size=128, val_freq=10 ** 9, seed=3)
_JAX_COMPUTE_NCC = jreg.compute_ncc

# ---- (a) the cameras ----

ECEF_CENTRES = {"none": None, "scene": (738_000.0, -5_497_000.0, 3_203_000.0),
                "north_pole": (0.0, 0.0, 6_356_752.0), "south_pole": (0.0, 0.0, -6_356_752.0)}


@pytest.mark.parametrize("centre", [c for c in ECEF_CENTRES if ECEF_CENTRES[c] is not None])
def test_enu_frame_matches(centre):
    got, want = tnadir.enu_frame(ECEF_CENTRES[centre]), jnadir.enu_frame(ECEF_CENTRES[centre])
    np.testing.assert_allclose(got, want, rtol=0, atol=CAM_TOL)
    np.testing.assert_allclose(got.T @ got, np.eye(3), rtol=0, atol=1e-12)


@pytest.mark.parametrize("theta,phi,radius", [(0.0, 0.0, 2.0), (30.0, -60.0, 3.0),
                                              (-135.0, 20.0, 1.5)])
def test_pose_spherical_matches(theta, phi, radius):
    np.testing.assert_allclose(tnadir.pose_spherical(theta, phi, radius),
                               jnadir.pose_spherical(theta, phi, radius), rtol=0, atol=CAM_TOL)


@pytest.mark.parametrize("centre", list(ECEF_CENTRES))
@pytest.mark.parametrize("pinhole", [False, True])
def test_nadir_cameras_match(pinhole, centre):
    """nadir_rays_with_sun in both branches, with and without a frame (the
    pole's too), at two downscales; and virtual_pinhole_rays off nadir."""
    frame = None if ECEF_CENTRES[centre] is None else jnadir.enu_frame(ECEF_CENTRES[centre])
    scale = np.array([110.0, 95.0, 21.0])
    for downscale in (1.0, 2.0):
        got = tnadir.nadir_rays_with_sun(40, 30, 35.0, 140.0, scale, img_downscale=downscale,
                                         pinhole=pinhole, frame=frame)
        want = jnadir.nadir_rays_with_sun(40, 30, 35.0, 140.0, scale, img_downscale=downscale,
                                          pinhole=pinhole, frame=frame)
        assert got[1:] == want[1:]
        assert got[0].dtype == np.float32 and got[0].shape == want[0].shape
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=CAM_TOL)
    got = tnadir.virtual_pinhole_rays(12, 10, 9.0, radius=2.5, el_deg=-70.0, az_deg=25.0,
                                      frame=frame)
    want = jnadir.virtual_pinhole_rays(12, 10, 9.0, radius=2.5, el_deg=-70.0, az_deg=25.0,
                                       frame=frame)
    np.testing.assert_allclose(got, want, rtol=0, atol=CAM_TOL)
    np.testing.assert_allclose(np.linalg.norm(got[:, 3:6], axis=1), 1.0, atol=1e-6)


# ---- (c) the eval run ----


@pytest.fixture(autouse=True)
def no_jitter(monkeypatch):
    monkeypatch.setattr(jreg, "compute_ncc", lambda u, v, irange, dx, dy: _JAX_COMPUTE_NCC(
        u, v, irange, dx, dy, use_native=False))
    monkeypatch.setattr(jrun, "RenderConfig", functools.partial(jrun.RenderConfig, perturb=False))
    monkeypatch.setattr(trun, "RenderConfig", functools.partial(trun.RenderConfig, perturb=False))


def _with_opts(run_dir, name, **opts):
    """A copy of a run directory under another name with opts.json edited."""
    dst = os.path.join(os.path.dirname(run_dir), name)
    shutil.copytree(run_dir, dst)
    path = os.path.join(dst, "opts.json")
    with open(path) as f:
        d = json.load(f)
    d.update(opts)
    with open(path, "w") as f:
        json.dump(d, f)
    return dst


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": (logs_dir, scene), "port": (logs_dir, scene)}: run "pair" (the
    JAX trainer's initial weights at epoch=0, imported into the port) and
    "pair_ecef" (the same with ecef=True)."""
    tmp = tmp_path_factory.mktemp("eval")
    spec = dict(n_views=2, n_test_views=1, img_size=SIZE, dsm_resolution=2.0)
    jinfo = jsyn.generate_scene(str(tmp / "jax_scene"), jsyn.SyntheticSceneSpec(**spec))
    pinfo = tsyn.generate_scene(str(tmp / "port_scene"), tsyn.SyntheticSceneSpec(**spec))
    jtr = jloop.Trainer(JaxConfig(root_dir=jinfo["root_dir"], img_dir=jinfo["img_dir"],
                                  gt_dir=jinfo["gt_dir"], aoi_id=jinfo["aoi_id"],
                                  logs_dir=str(tmp / "jax_logs"), exp_name="pair", **CFG))
    jtr.save()
    imp_spec = importlib.util.spec_from_file_location("import_jax_run",
                                                      REPO / "import_jax_run.py")
    imp = importlib.util.module_from_spec(imp_spec)
    imp_spec.loader.exec_module(imp)
    imp.main([jtr.log_dir, str(tmp / "port_logs" / "pair")])
    for logs in ("jax_logs", "port_logs"):
        _with_opts(str(tmp / logs / "pair"), "pair_ecef", ecef=True)
    return {"jax": (str(tmp / "jax_logs"), jinfo), "port": (str(tmp / "port_logs"), pinfo),
            "out": tmp / "out"}


def _spy(monkeypatch, module, name, record, keep):
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        out = fn(*args, **kwargs)
        record.append(keep(out))
        return out

    monkeypatch.setattr(module, name, spy)


def _eval_both(runs, monkeypatch, tag, run_id="pair", **kw):
    """(port result, JAX result, {"port", "jax"}: rendered depths,
    {"port", "jax"}: registration shifts, {"port", "jax"}: output dirs)."""
    depths, shifts = {"port": [], "jax": []}, {"port": [], "jax": []}
    _spy(monkeypatch, trun, "render_image", depths["port"], lambda o: o["depth"].numpy())
    _spy(monkeypatch, jrun, "render_image", depths["jax"], lambda o: np.asarray(o["depth"]))
    _spy(monkeypatch, tdsm, "compute_shift_arrays", shifts["port"], lambda o: o[:2])
    _spy(monkeypatch, jdsm, "compute_shift_arrays", shifts["jax"], lambda o: o[:2])
    outs = {k: str(runs["out"] / tag / k) for k in ("port", "jax")}
    logs, info = runs["port"]
    got = trun.eval_eonerf(run_id, logs, outs["port"], root_dir=info["root_dir"],
                           img_dir=info["img_dir"], gt_dir=info["gt_dir"], device="cpu", **kw)
    want = jrun.eval_eonerf(run_id, runs["jax"][0], outs["jax"], **kw)
    return got, want, depths, shifts, outs


@pytest.mark.parametrize("run_id,nadir_frame,pinhole", [
    ("pair", "auto", False), ("pair", "auto", True), ("pair_ecef", "auto", False),
    ("pair_ecef", "zup", False)])
def test_dsm_eval_matches(runs, monkeypatch, run_id, nadir_frame, pinhole):
    """The DSM sweep: the depth, the DSM raster, the registration shift,
    then the registered MAE; the same files written."""
    tag = f"{run_id}_{nadir_frame}_{pinhole}"
    got, want, depths, shifts, outs = _eval_both(
        runs, monkeypatch, tag, run_id=run_id, dsm=True, dsm_resolution=2.0,
        nadir_frame=nadir_frame, pinhole=pinhole)
    assert sorted(got) == sorted(want) == ["dsm_path", "mae", "rdsm_path"]
    assert len(depths["port"]) == len(depths["jax"]) == 1
    assert depths["port"][0].shape == (SIZE * SIZE, 1)
    np.testing.assert_allclose(depths["port"][0], depths["jax"][0], rtol=0, atol=DEPTH_TOL)
    rasters = [GeoTiffFile(r["dsm_path"]).read(1) for r in (got, want)]
    assert rasters[0].shape == rasters[1].shape
    np.testing.assert_array_equal(np.isnan(rasters[0]), np.isnan(rasters[1]))
    np.testing.assert_allclose(rasters[0], rasters[1], rtol=0, atol=DSM_TOL_M)
    assert len(shifts["port"]) == 1 and shifts["port"] == shifts["jax"], shifts
    assert np.isfinite(got["mae"]) and abs(got["mae"] - want["mae"]) <= MAE_TOL_M
    assert os.path.exists(got["rdsm_path"])
    rel = sorted(str(p.relative_to(outs["jax"])) for p in pathlib.Path(outs["jax"]).rglob("*"))
    assert sorted(str(p.relative_to(outs["port"]))
                  for p in pathlib.Path(outs["port"]).rglob("*")
                  if "rdsm_epoch" not in p.name) == [p for p in rel if "rdsm_epoch" not in p]


def test_report_eval_matches(runs, monkeypatch):
    """dsm=False: one row a roster view (2 train, 1 test), loss and PSNR."""
    got, want, depths, _, _ = _eval_both(runs, monkeypatch, "report")
    assert [r["src_id"] for r in got] == [r["src_id"] for r in want]
    assert len(got) == 3 and len(depths["port"]) == 3
    for g, w in zip(got, want):
        for key in ("loss", "psnr"):
            np.testing.assert_allclose(g[key], w[key], rtol=METRIC_RTOL, err_msg=key)
    for a, b in zip(depths["port"], depths["jax"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=DEPTH_TOL)


def test_eval_refuses_what_the_port_lacks(runs, tmp_path):
    """data_axis past one device (refused until the data-parallel slice)
    renders over two gloo ranks: without jitter the DSM is the one-device
    eval's, bit for bit, and so are its MAE and the report; rank 0 returns
    the results, rank 1 None. A checkpoint inside the coarse-to-fine ramp
    (refused until the bundle-adjustment slice) evaluates through its
    step's PE mask (step 0: the identity only); the same run at its end
    step loads unmasked."""
    from eonerf_code_tpu_torch.parallel import mesh as pmesh
    from test_torch_parallel import eval_without_jitter

    logs, info = runs["port"]
    kw = dict(run_id="pair", logs_dir=logs, root_dir=info["root_dir"], img_dir=info["img_dir"],
              gt_dir=info["gt_dir"], dsm_resolution=2.0)
    one = [trun.eval_eonerf(output_dir=str(tmp_path / f"dp1_{dsm}"), dsm=dsm, data_axis=1,
                            device="cpu", **kw) for dsm in (True, False)]
    two = pmesh.launch(eval_without_jitter, {"calls": [
        dict(output_dir=str(tmp_path / f"dp2_{dsm}"), dsm=dsm, data_axis=2, **kw)
        for dsm in (True, False)]}, 2, "cpu")
    assert two[1] == [None, None]
    assert two[0][0]["mae"] == one[0]["mae"] and two[0][1] == one[1]
    np.testing.assert_array_equal(GeoTiffFile(two[0][0]["dsm_path"]).read(1),
                                  GeoTiffFile(one[0]["dsm_path"]).read(1))
    ramp = _with_opts(os.path.join(logs, "pair"), "pair_ramp", freq_reg_end_step=100)
    out = trun.eval_eonerf("pair_ramp", logs, str(tmp_path), root_dir=info["root_dir"],
                           img_dir=info["img_dir"], gt_dir=info["gt_dir"], dsm=True,
                           dsm_resolution=2.0, device="cpu")
    assert np.isfinite(out["mae"]) and os.path.exists(out["dsm_path"])
    _, rf, field = trun.load_run(ramp, device="cpu")
    assert isinstance(rf, PEMaskedField) and rf.field is field
    assert torch.equal(rf.pe_mask[:3], torch.ones(3)) and rf.pe_mask[3:].abs().max() == 0
    path = os.path.join(ramp, "ckpts", "epoch=0")
    state = ckpt_lib.restore_checkpoint(path)
    state["step"] = 100
    torch.save(state, os.path.join(path, ckpt_lib.STATE_FILE))
    cfg, rf, field = trun.load_run(ramp, device="cpu")
    assert cfg.freq_reg_end_step == 100 and field.net_width == 32 and rf is field
