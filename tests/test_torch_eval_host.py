"""The port's host DSM evaluation against the JAX package: the registration
(eval/registration.py, against the JAX numpy search, ``use_native=False``),
the crop, water mask, error map and MAE (eval/dsm.py) on the generated
scene's GT and a shifted, noisy copy of it, the local-frame rasteriser and
the ECEF -> UTM frame (eval/device.py), ``visualize_depth`` and the image
panels of the metrics logger. Inputs are made from seeds with numpy.

Tolerances: shifts equal, arrays of the same float64 arithmetic within
1e-9, the MAE within 1e-6 m, the rasteriser within 1e-4 (float32 on both
sides, the JAX package's own pin), the frame within 1e-9 relative."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.lib.stride_tricks import sliding_window_view

from eonerf_code_tpu.data import synthetic as jsyn
from eonerf_code_tpu.eval import device as jdev
from eonerf_code_tpu.eval import dsm as jdsm
from eonerf_code_tpu.eval import registration as jreg
from eonerf_code_tpu.io import geotiff as jtif
from eonerf_code_tpu.utils import tb as jtb
from eonerf_code_tpu.utils import viz as jviz
from eonerf_code_tpu_torch.eval import device as tdev
from eonerf_code_tpu_torch.eval import dsm as tdsm
from eonerf_code_tpu_torch.eval import registration as treg
from eonerf_code_tpu_torch.io import geotiff as ttif
from eonerf_code_tpu_torch.utils import tb as ttb
from eonerf_code_tpu_torch.utils import viz as tviz

F64_TOL = dict(rtol=0, atol=1e-9)
MAE_TOL = 1e-6
SHIFT = (3, -2)          # (dx, dy) in GT cells


_JAX_COMPUTE_NCC = jreg.compute_ncc


def jax_ncc(u, v, irange, dx, dy):
    return _JAX_COMPUTE_NCC(u, v, irange, dx, dy, use_native=False)


@pytest.fixture(autouse=True)
def numpy_search(monkeypatch):
    """The JAX package's search on its numpy path, the reference the port's
    native search is held to (tests/test_torch_native.py): recursive_ncc
    reads compute_ncc from its module."""
    monkeypatch.setattr(jreg, "compute_ncc", jax_ncc)


def smooth(rng, h, w, amp=4.0):
    base = rng.standard_normal((h + 8, w + 8)) * amp
    return sliding_window_view(base, (9, 9)).mean(axis=(2, 3))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The generated scene's GT rasters (106 x 106 cells at 1.5 m: one
    pyramid level), and a predicted DSM on the same grid: the GT moved by
    SHIFT, raised 2.5 m, with seeded noise and holes."""
    out = str(tmp_path_factory.mktemp("eval_scene"))
    info = jsyn.generate_scene(out, jsyn.SyntheticSceneSpec(
        n_views=1, n_test_views=1, img_size=8, dsm_resolution=1.5, n_buildings=4))
    gt_path = os.path.join(info["gt_dir"], f"{info['aoi_id']}_DSM.tif")
    src = ttif.GeoTiffFile(gt_path)
    gt = src.read(1).astype(np.float64)
    rng = np.random.default_rng(5)
    dx, dy = SHIFT
    pred = np.roll(gt, (dy, dx), axis=(0, 1)) + 2.5 + rng.normal(0, 0.3, gt.shape)
    pred[10:20, 30:45] = np.nan
    pred_path = os.path.join(out, "pred.tif")
    ttif.write_geotiff(pred_path, pred.astype(np.float32), profile=src.profile)
    return dict(info, gt_path=gt_path, pred_path=pred_path, gt=gt, pred=pred, src=src)


def test_downsample_stats_and_ncc_match():
    rng = np.random.default_rng(0)
    u = smooth(rng, 37, 41)[None]
    v = np.roll(u, (1, 2), axis=(1, 2)) + rng.normal(0, 0.1, u.shape)
    u[0, 3:9, 5:7] = np.nan
    v[0, 20:25, 10:30] = np.nan
    np.testing.assert_array_equal(treg.downsample2x(u), jreg.downsample2x(u))
    for dx, dy in ((0, 0), (2, 1), (-3, 4), (50, 0)):
        np.testing.assert_allclose(treg.masked_stats(u, v, dx, dy),
                                   jreg.masked_stats(u, v, dx, dy), **F64_TOL)
        assert treg.ncc(u, v, dx, dy) == pytest.approx(jreg.ncc(u, v, dx, dy), abs=1e-12)


@pytest.mark.parametrize("size,shift", [((60, 70), (2, -3)), ((230, 210), (-7, 9))])
def test_shift_search_matches(size, shift):
    """compute_ncc at one level, recursive_ncc through the pyramid (230 x 210
    takes one halving) and compute_shift_arrays give the same (dx, dy), and
    the same fitted (a, b) at 1e-9."""
    rng = np.random.default_rng(1)
    gt = smooth(rng, *size)
    pred = np.roll(gt, (shift[1], shift[0]), axis=(0, 1)) * 1.1 + 0.7
    pred[5:15, 5:25] = np.nan
    u, v = gt[None], pred[None]
    assert treg.compute_ncc(u, v, 5, 0, 0) == jax_ncc(u, v, 5, 0, 0)
    got = treg.recursive_ncc(u, v)
    assert got == jreg.recursive_ncc(u, v) == shift
    for scaling in (True, False):
        t = treg.compute_shift_arrays(gt, pred, scaling=scaling)
        j = jreg.compute_shift_arrays(gt, pred, scaling=scaling)
        assert t[:2] == j[:2] == shift
        np.testing.assert_allclose(t[2:], j[2:], **F64_TOL)


def test_ties_resolve_alike():
    """A constant field scores -inf everywhere, so the initial shift stays;
    a field periodic in x scores near 1 at every even dx, and both sides
    take the same candidate of the y-major scan."""
    u = np.ones((1, 20, 20))
    assert treg.compute_ncc(u, u, 2, 1, 1) == jax_ncc(u, u, 2, 1, 1) == (1, 1)
    rows = np.random.default_rng(3).standard_normal(24)
    u = (rows[:, None] * (-1.0) ** np.arange(24)[None, :])[None]
    got = treg.compute_ncc(u, u, 3, 0, 0)
    assert got == jax_ncc(u, u, 3, 0, 0) and got[1] == 0 and got[0] % 2 == 0


@pytest.mark.parametrize("dx,dy,a,b", [(0, 0, 1, 0), (3, -2, 1.0, 2.5), (-40, 7, 0.9, -1.0)])
def test_apply_shift_matches(dx, dy, a, b):
    v = smooth(np.random.default_rng(2), 30, 35)
    np.testing.assert_allclose(treg.apply_shift_arrays(v, dx, dy, a, b),
                               jreg.apply_shift_arrays(v, dx, dy, a, b), **F64_TOL)
    np.testing.assert_allclose(treg.apply_shift_arrays(v[None], dx, dy, a, b),
                               jreg.apply_shift_arrays(v[None], dx, dy, a, b), **F64_TOL)


def test_file_interfaces_match(scene, tmp_path):
    t = treg.compute_shift(scene["gt_path"], scene["pred_path"], scaling=False)
    j = jreg.compute_shift(scene["gt_path"], scene["pred_path"], scaling=False)
    assert t[:2] == j[:2] == SHIFT
    np.testing.assert_allclose(t[2:], j[2:], **F64_TOL)
    treg.apply_shift(scene["pred_path"], str(tmp_path / "t.tif"), *t)
    jreg.apply_shift(scene["pred_path"], str(tmp_path / "j.tif"), *j)
    with open(tmp_path / "t.tif", "rb") as f, open(tmp_path / "j.tif", "rb") as g:
        assert f.read() == g.read()


def test_crop_to_projwin_matches(scene):
    t = scene["src"].transform
    for window in ((t.c + 7.5, t.f - 4.5, t.c + 81.0, t.f - 96.0, 1.5),
                   (t.c - 20.0, t.f + 10.0, t.c + 60.0, t.f - 50.0, 2.0)):   # past the edge
        got, gt_tr = tdsm.crop_to_projwin(ttif.GeoTiffFile(scene["gt_path"]), *window)
        want, want_tr = jdsm.crop_to_projwin(jtif.GeoTiffFile(scene["gt_path"]), *window)
        np.testing.assert_array_equal(got, want)
        assert tuple(gt_tr) == tuple(want_tr)


def test_water_mask_matches(scene, tmp_path):
    """Class 9 of the CLS raster, and the WATER.png beside it that
    overrides it."""
    from PIL import Image

    cls = np.full((12, 10), 2, np.uint8)
    cls[3:6, 2:8] = 9
    path = str(tmp_path / "AOI_CLS.tif")
    ttif.write_geotiff(path, cls)
    np.testing.assert_array_equal(tdsm._load_water_mask(path), jdsm._load_water_mask(path))
    assert tdsm._load_water_mask(path).sum() == 18
    png = np.full((12, 10), 255, np.uint8)
    png[0:2] = 0
    Image.fromarray(png).save(str(tmp_path / "AOI_WATER.png"))
    np.testing.assert_array_equal(tdsm._load_water_mask(path), jdsm._load_water_mask(path))
    assert tdsm._load_water_mask(path).sum() == 20


def test_pointwise_diff_and_mae_match(scene, tmp_path):
    """The error map (registered, water-masked, clipped) and the MAE of the
    shifted, raised, noisy copy; the written rdsm and error rasters the same
    bytes."""
    src = scene["src"]
    meta = (src.bounds.left, src.bounds.bottom, min(src.height, src.width), src.res[0])
    cls = os.path.join(scene["gt_dir"], f"{scene['aoi_id']}_CLS.tif")
    out = {}
    for name, mod in (("t", tdsm), ("j", jdsm)):
        err = mod.dsm_pointwise_diff(scene["pred_path"], scene["gt_path"], meta, gt_mask_path=cls,
                                     out_rdsm_path=str(tmp_path / f"{name}_r.tif"),
                                     out_err_path=str(tmp_path / f"{name}_e.tif"))
        out[name] = (err, mod.dsm_mae(scene["pred_path"], scene["gt_path"], meta, cls))
    np.testing.assert_allclose(out["t"][0], out["j"][0], **F64_TOL)
    assert abs(out["t"][1] - out["j"][1]) <= MAE_TOL
    assert out["t"][1] < 0.5            # the shift and the 2.5 m found: the noise is left
    for suffix in ("r", "e"):
        with open(tmp_path / f"t_{suffix}.tif", "rb") as f, \
                open(tmp_path / f"j_{suffix}.tif", "rb") as g:
            assert f.read() == g.read()


@pytest.mark.parametrize("save", [True, False])
def test_compute_mae_and_save_dsm_diff_matches(scene, tmp_path, save):
    """The synthetic AOI takes the ROI from the GT raster's bounds; with
    save the registered DSM and its error map stay on disk."""
    maes = [mod.compute_mae_and_save_dsm_diff(scene["pred_path"], "view", scene["gt_dir"],
                                              str(tmp_path / name), 3, scene["aoi_id"],
                                              save=save)
            for name, mod in (("t", tdsm), ("j", jdsm))]
    assert abs(maes[0] - maes[1]) <= MAE_TOL
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    assert len(os.listdir(tmp_path / "t")) == (2 if save else 0)
    with pytest.raises(FileNotFoundError):
        tdsm.compute_mae_and_save_dsm_diff(scene["pred_path"], "view", scene["gt_dir"],
                                           str(tmp_path / "x"), 3, "SYN_000")


def test_rasterize_local_matches():
    rng = np.random.default_rng(6)
    e, n = rng.uniform(-15, 15, 500), rng.uniform(-15, 15, 500)
    a = rng.uniform(0, 20, 500)
    f32 = [x.astype(np.float32) for x in (e, n, a)]
    got = tdev.rasterize_local(*(torch.from_numpy(x) for x in f32), -16.0, 15.5, 1.0, 31, 30)
    want = np.asarray(jdev.rasterize_local(*(jnp.asarray(x) for x in f32), -16.0, 15.5, 1.0,
                                           31, 30))
    assert got.dtype == torch.float32 and got.shape == (30, 31)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4, equal_nan=True)


@pytest.mark.parametrize("center_lla,zone,south", [((30.35, -81.66, 5.0), 17, False),
                                                   ((-33.9, 151.2, 40.0), 56, True),
                                                   ((45.0, 2.9, 100.0), 31, False)])
def test_ecef_to_utm_frame_matches(center_lla, zone, south):
    """The exact-Jacobian frame at a scene centre, north and south, and near
    a zone edge."""
    from eonerf_code_tpu_torch.geo import latlon_to_ecef

    center = np.array([float(c[0]) for c in latlon_to_ecef(*(np.array([x]) for x in center_lla))])
    jac, origin = tdev.ecef_to_utm_frame(center, zone, south)
    jjac, jorigin = jdev.ecef_to_utm_frame(center, zone, south)
    np.testing.assert_allclose(jac, jjac, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(origin, jorigin, rtol=1e-9)


def test_visualize_depth_matches():
    rng = np.random.default_rng(7)
    d = rng.uniform(0.2, 1.4, (9, 11))
    d[2, 3] = np.nan
    for args in ((d,), (d, 0.5, 1.0), (np.full((3, 4), np.nan),), (np.full((2, 2), 0.7),)):
        got, want = tviz.visualize_depth(*args), jviz.visualize_depth(*args)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


class _Writer:
    def __init__(self):
        self.images = []

    def add_image(self, tag, img, step):
        self.images.append((tag, np.asarray(img), step))

    def flush(self):
        pass

    close = flush


def test_image_panel_matches(tmp_path):
    """The panel both loggers hand to TensorBoard: gt, pred, a mask and a
    depth colouring side by side, cut to the lowest height, clipped."""
    rng = np.random.default_rng(8)
    panel = [rng.uniform(-0.2, 1.2, (6, 5, 3)), rng.random((6, 5, 3)), rng.random((7, 5)),
             rng.random((6, 4, 1))]
    logged = []
    for name, mod in (("t", ttb), ("j", jtb)):
        logger = mod.MetricsLogger(str(tmp_path / name), use_tensorboard=False)
        logger._tb = _Writer()
        logger.image_panel("val_0/gt_pred_depth", panel, 4)
        logger.image("one", panel[2], 5)
        logged.append(logger._tb.images)
        logger.close()
    for (tag, img, step), (jtag, jimg, jstep) in zip(*logged):
        assert (tag, step) == (jtag, jstep)
        np.testing.assert_array_equal(img, jimg)
    assert logged[0][0][1].shape == (3, 6, 19)
