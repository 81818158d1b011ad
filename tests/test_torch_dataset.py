"""The port's data slice against the JAX package: the generated scene (the
same files byte for byte), GeoTIFF I/O, the RPC camera, UTM and ECEF, the
view roster, the train split's ray pool with every option the trainer
passes (ECEF, priors, shadow masks, subset, downscale, the ray cache), the
DSM from depth, and the trainer's pool built from ``cfg.root_dir``. Each
package generates its own copy of the scene and reads only that copy, so
the scene-level caches (``scene.loc_*``, ``scene.radiometry``) are each
package's own. The views are 32x32, where the JAX package localizes with
its numpy path too."""

import os

import numpy as np
import pytest
import torch

from eonerf_code_tpu import geo as jgeo
from eonerf_code_tpu.data import satellite as jsat
from eonerf_code_tpu.data import synthetic as jsyn
from eonerf_code_tpu.data import views as jviews
from eonerf_code_tpu.io import geotiff as jtif
from eonerf_code_tpu_torch import geo as tgeo
from eonerf_code_tpu_torch.config import TrainConfig
from eonerf_code_tpu_torch.data import satellite as tsat
from eonerf_code_tpu_torch.data import synthetic as tsyn
from eonerf_code_tpu_torch.data import views as tviews
from eonerf_code_tpu_torch.io import geotiff as ttif
from eonerf_code_tpu_torch.train import loop as tloop

F64_TOL = dict(rtol=0, atol=1e-12)
GEO_TOL = dict(rtol=0, atol=1e-9)
SIZE = 32


def _snapshot(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The same spec generated by each package into its own directory, the
    files of each read back right after, and shadow masks (random uint8
    rasters, one per view) and a confidence raster shared by both."""
    spec = dict(n_views=4, n_test_views=1, img_size=SIZE)
    jdir = str(tmp_path_factory.mktemp("jax_scene"))
    tdir = str(tmp_path_factory.mktemp("port_scene"))
    jinfo = jsyn.generate_scene(jdir, jsyn.SyntheticSceneSpec(**spec))
    tinfo = tsyn.generate_scene(tdir, tsyn.SyntheticSceneSpec(**spec))
    files = (_snapshot(jdir), _snapshot(tdir))
    shared = str(tmp_path_factory.mktemp("shared"))
    rng = np.random.default_rng(3)
    masks = os.path.join(shared, "masks")
    os.makedirs(masks)
    for name in tinfo["names"]:
        ttif.write_geotiff(os.path.join(masks, name + ".tif"),
                           rng.integers(0, 256, (SIZE, SIZE)).astype(np.uint8))
    dsm = os.path.join(tinfo["gt_dir"], f"{tinfo['aoi_id']}_DSM.tif")
    src = ttif.GeoTiffFile(dsm)
    conf = np.full((src.height, src.width), 5.0, np.float32)
    conf[: src.height // 2] = 1.0
    conf_path = os.path.join(shared, "conf.tif")
    ttif.write_geotiff(conf_path, conf, profile=src.profile)
    return dict(jax=jinfo, port=tinfo, files=files, masks=masks, conf=conf_path)


def test_generate_scene_writes_the_same_files(scenes):
    jfiles, tfiles = scenes["files"]
    assert sorted(jfiles) == sorted(tfiles) and len(tfiles) == 5 * 2 + 2 + 3
    assert [k for k in tfiles if jfiles[k] != tfiles[k]] == []
    assert scenes["jax"]["names"] == scenes["port"]["names"]


def test_geotiff_matches(scenes, tmp_path):
    """Each package's writer gives the same bytes, and each reads the
    other's files back to the same arrays, georeferencing and nodata."""
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=(3, 7, 5)).astype(np.float32),
              rng.integers(0, 256, (6, 9)).astype(np.uint8),
              rng.integers(0, 4000, (2, 4, 4)).astype(np.uint16)]
    crs = ttif.CRS.from_utm_zone(17, False)
    transform = ttif.Affine(0.5, 0.0, 4.0e5, 0.0, -0.5, 3.3e6)
    for i, a in enumerate(arrays):
        pj, pt = str(tmp_path / f"j{i}.tif"), str(tmp_path / f"t{i}.tif")
        jtif.write_geotiff(pj, a, crs=jtif.CRS.from_utm_zone(17, False),
                           transform=jtif.Affine(*transform), nodata=-1.0)
        ttif.write_geotiff(pt, a, crs=crs, transform=transform, nodata=-1.0)
        with open(pj, "rb") as f, open(pt, "rb") as g:
            assert f.read() == g.read()
        for path in (pj, pt):
            np.testing.assert_array_equal(ttif.read_geotiff(path), jtif.read_geotiff(path))
            tf, jf = ttif.GeoTiffFile(path), jtif.GeoTiffFile(path)
            assert tuple(tf.transform) == tuple(jf.transform)
            assert tf.nodata == jf.nodata and tf.crs.epsg == jf.crs.epsg == 32617
    dsm = os.path.join(scenes["port"]["gt_dir"], "SYN_068_DSM.tif")
    np.testing.assert_array_equal(ttif.read_geotiff(dsm), jtif.read_geotiff(dsm))


def _rpcs(scenes):
    path = os.path.join(scenes["port"]["root_dir"], scenes["port"]["names"][1] + ".json")
    d = tsat.read_json(path)
    return tgeo.RPCModel(d["rpc"]), jgeo.RPCModel(d["rpc"])


def test_rpc_matches(scenes):
    """Projection and localization (the numpy Newton solve; the JAX side's
    native library is not reached below 4096 points), the rescaled camera
    and the incidence angles."""
    trpc, jrpc = _rpcs(scenes)
    rng = np.random.default_rng(1)
    cols, rows = rng.uniform(0, SIZE, 500), rng.uniform(0, SIZE, 500)
    alts = rng.uniform(-2.0, 32.0, 500)
    lon, lat = trpc.localization(cols, rows, alts)
    jlon, jlat = jrpc.localization(cols, rows, alts)
    np.testing.assert_allclose(lon, jlon, **GEO_TOL)
    np.testing.assert_allclose(lat, jlat, **GEO_TOL)
    for got, want in zip(trpc.projection(lon, lat, alts), jrpc.projection(lon, lat, alts)):
        np.testing.assert_allclose(got, want, **GEO_TOL)
    np.testing.assert_allclose(trpc.projection(lon, lat, alts)[0], cols, atol=1e-6)
    assert trpc.rescaled(0.5).to_dict() == jrpc.rescaled(0.5).to_dict()
    lon0, lat0 = float(lon[0]), float(lat[0])
    np.testing.assert_allclose(trpc.incidence_angles(lon0, lat0),
                               jrpc.incidence_angles(lon0, lat0), **GEO_TOL)


def test_utm_and_ecef_match():
    rng = np.random.default_rng(2)
    lat = np.concatenate([rng.uniform(-79.0, 83.0, 300), [30.35, -33.9, 60.5, 78.2]])
    lon = np.concatenate([rng.uniform(-179.0, 179.0, 300), [-81.66, 18.4, 5.3, 15.6]])
    alt = rng.uniform(-50.0, 500.0, lat.size)
    e, n = tgeo.utm_from_latlon(lat, lon)
    je, jn = jgeo.utm_from_latlon(lat, lon)
    np.testing.assert_allclose(e, je, **GEO_TOL)
    np.testing.assert_allclose(n, jn, **GEO_TOL)
    zone = tgeo.latlon_to_zone_number(30.35, -81.66)
    assert zone == jgeo.latlon_to_zone_number(30.35, -81.66)
    assert ([tgeo.latitude_to_zone_letter(x) for x in lat[:20]]
            == [jgeo.latitude_to_zone_letter(x) for x in lat[:20]])
    assert (tgeo.utm_zonestring_from_lonlat(-81.66, 30.35)
            == jgeo.utm_zonestring_from_lonlat(-81.66, 30.35))
    for got, want in zip(tgeo.lonlat_from_utm(e[:10], n[:10], f"{zone}N"),
                         jgeo.lonlat_from_utm(e[:10], n[:10], f"{zone}N")):
        np.testing.assert_allclose(got, want, **GEO_TOL)
    xyz = tgeo.latlon_to_ecef(lat, lon, alt)
    for got, want in zip(xyz, jgeo.latlon_to_ecef(lat, lon, alt)):
        np.testing.assert_allclose(got, want, **GEO_TOL)
    for got, want in zip(tgeo.ecef_to_latlon(*xyz), jgeo.ecef_to_latlon(*xyz)):
        np.testing.assert_allclose(got, want, **GEO_TOL)


def test_view_roster_matches(scenes):
    base = [os.path.basename(p) for p in
            tviews.sort_by_increasing_view_incidence_angle(scenes["port"]["root_dir"])]
    assert base == [os.path.basename(p) for p in
                    jviews.sort_by_increasing_view_incidence_angle(scenes["jax"]["root_dir"])]
    assert (tviews.sort_by_acquisition_date(scenes["port"]["root_dir"])
            == [p.replace(scenes["jax"]["root_dir"], scenes["port"]["root_dir"])
                for p in jviews.sort_by_acquisition_date(scenes["jax"]["root_dir"])])


def _options(scenes, which, case, tmp):
    info = scenes[which]
    dsm = os.path.join(info["gt_dir"], f"{info['aoi_id']}_DSM.tif")
    return {"plain": {},
            "ecef": dict(utm=False),
            "priors": dict(prior_dsm_path=dsm, prior_conf_path=scenes["conf"]),
            "shadow_masks": dict(shadow_masks_dir=scenes["masks"]),
            "subset": dict(subset=2),
            "downscale": dict(img_downscale=2.0),
            "cache": dict(cache_dir=os.path.join(tmp, which), prior_dsm_path=dsm)}[case]


def _pool_fields(ds):
    return dict(rays=ds.all_rays, rgbs=ds.all_rgbs, ids=ds.all_ids_img,
                shapes=ds.all_img_shapes, depth=ds.prior_depths, conf=ds.prior_confs,
                shadow=ds.prior_shadows, envelope=np.asarray(ds.alt_envelope()))


@pytest.mark.parametrize("case", ["plain", "ecef", "priors", "shadow_masks", "subset",
                                  "downscale", "cache"])
def test_pool_matches(scenes, case, tmp_path):
    """The train split's arrays through both packages, each on its own copy
    of the scene: the ray pool, rgbs, image ids and shapes, the priors and
    the altitude envelope exactly, the scene's offset and scale (float64) to
    1e-12. "cache" builds twice, the second time from the ray and depth
    caches."""
    def build(pkg, which):
        info = scenes[which]
        return pkg.SatelliteDataset(info["root_dir"], info["img_dir"], split="train",
                                    **_options(scenes, which, case, str(tmp_path)))

    tds, jds = build(tsat, "port"), build(jsat, "jax")
    if case == "cache":
        # a ray and a depth cache per view, and the scene's radiometric scale
        assert len(os.listdir(tmp_path / "port")) == 2 * 4 + 1
        tds = build(tsat, "port")
    got, want = _pool_fields(tds), _pool_fields(jds)
    for key in got:
        if want[key] is None:
            assert got[key] is None, key
        else:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    n = tds.all_rays.shape[0]
    assert n == {"subset": 2, "downscale": 4 * 0.25}.get(case, 4) * SIZE * SIZE
    assert (tds.prior_depths is not None) == (case in ("priors", "cache"))
    np.testing.assert_allclose(tds.scene.scene_offset, jds.scene.scene_offset, **F64_TOL)
    np.testing.assert_allclose(tds.scene.scene_scale, jds.scene.scene_scale, **F64_TOL)
    assert tds.radiometric_scale == jds.radiometric_scale
    assert tds.scene.utm_zonestring == jds.scene.utm_zonestring


@pytest.mark.parametrize("utm", [True, False])
def test_dsm_from_depth_matches(scenes, utm, tmp_path):
    """Depth to (east, north, alt) in float64 and the rasterised DSM (the
    port's ops/raster.py on float64 CPU tensors; the JAX package's numpy
    scatter) written as a GeoTIFF."""
    tds = tsat.SatelliteDataset(scenes["port"]["root_dir"], scenes["port"]["img_dir"], utm=utm)
    jds = jsat.SatelliteDataset(scenes["jax"]["root_dir"], scenes["jax"]["img_dir"], utm=utm)
    rays = tds.all_rays[: SIZE * SIZE]
    depth = np.random.default_rng(4).uniform(0.3, 0.7, rays.shape[0]).astype(np.float32)
    depth[:7] = -1.0
    for got, want in zip(tds.utmalt_from_depth(rays, depth), jds.utmalt_from_depth(rays, depth)):
        np.testing.assert_allclose(got, want, **F64_TOL)
    dsm = tds.dsm_from_depth(rays, depth, str(tmp_path / "t.tif"), resolution=2.0)
    jdsm = jds.dsm_from_depth(rays, depth, str(tmp_path / "j.tif"), resolution=2.0)
    assert dsm.shape == jdsm.shape and dsm.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(dsm), np.isnan(jdsm))
    np.testing.assert_allclose(dsm, jdsm, **GEO_TOL)
    np.testing.assert_allclose(ttif.read_geotiff(str(tmp_path / "t.tif")),
                               jtif.read_geotiff(str(tmp_path / "j.tif")), rtol=1e-6)


def test_trainer_builds_the_dataset_pool(scenes, tmp_path):
    """Trainer(cfg with root_dir) puts the dataset's pool on the device, with
    the image count and the altitude envelope that sampler="auto" reads:
    the pool Trainer(cfg, data=...) gets from the JAX dataset's arrays, the
    same sampler resolution."""
    info = scenes["port"]
    dsm = os.path.join(info["gt_dir"], f"{info['aoi_id']}_DSM.tif")

    def cfg(name, **kw):
        return TrainConfig(logs_dir=str(tmp_path), exp_name=name, net_depth=2, net_width=32,
                           shadow_masks_dir=scenes["masks"], **kw)

    tr = tloop.Trainer(cfg("ds", root_dir=info["root_dir"], img_dir=info["img_dir"],
                           init_dsm_path=dsm), device="cpu")
    jinfo = scenes["jax"]
    jds = jsat.SatelliteDataset(jinfo["root_dir"], jinfo["img_dir"], split="train",
                                prior_dsm_path=os.path.join(jinfo["gt_dir"], "SYN_068_DSM.tif"),
                                shadow_masks_dir=scenes["masks"])
    data = {"rays": jds.all_rays, "rgbs": jds.all_rgbs.astype(np.float32),
            "ts": jds.all_ids_img[:, 0].astype(np.int32), "depth_prior": jds.prior_depths,
            "shadow_prior": jds.prior_shadows}
    ref = tloop.Trainer(cfg("pool"), data, len(jds.json_files), device="cpu",
                        alt_envelope=jds.alt_envelope())
    assert tr.n_images == ref.n_images == 4 and tr.alt_envelope == (-2.0, 32.0)
    assert tr.cfg.sampler == ref.cfg.sampler == "tighten"
    assert sorted(tr.device_data) == sorted(ref.device_data)
    for key, v in tr.device_data.items():
        assert torch.equal(v, ref.device_data[key]), key
