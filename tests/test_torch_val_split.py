"""The port's val split and the pixel/ray index algebra against the JAX
package's data/satellite.py. Each package generates its own copy of one
scene (3 train views, 2 test views, 16 x 16) and reads only that copy.

Tolerances: rosters, image ids, shapes, colours and indices equal; rays
within GEO_TOL (float32 from the same float64 geodesy)."""

import os

import numpy as np
import pytest

from eonerf_code_tpu.data import satellite as jsat
from eonerf_code_tpu.data import synthetic as jsyn
from eonerf_code_tpu_torch.data import satellite as tsat
from eonerf_code_tpu_torch.data import synthetic as tsyn

GEO_TOL = dict(rtol=0, atol=1e-9)
SIZE = 16
N_TRAIN, N_TEST = 3, 2


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    spec = dict(n_views=N_TRAIN, n_test_views=N_TEST, img_size=SIZE)
    jinfo = jsyn.generate_scene(str(tmp_path_factory.mktemp("jax_val")),
                                jsyn.SyntheticSceneSpec(**spec))
    tinfo = tsyn.generate_scene(str(tmp_path_factory.mktemp("port_val")),
                                tsyn.SyntheticSceneSpec(**spec))
    return {"jax": jinfo, "port": tinfo}


def _pair(scenes, split, **kw):
    t, j = scenes["port"], scenes["jax"]
    return (tsat.SatelliteDataset(t["root_dir"], t["img_dir"], split=split, **kw),
            jsat.SatelliteDataset(j["root_dir"], j["img_dir"], split=split, **kw))


@pytest.mark.parametrize("utm", [True, False])
def test_val_roster_matches(scenes, utm):
    """The first train view as an overfit probe (image id 0), then the test
    roster with ids after the train roster; no pool is built."""
    tds, jds = _pair(scenes, "val", utm=utm)
    names = [os.path.basename(p) for p in tds.json_files]
    assert names == [os.path.basename(p) for p in jds.json_files]
    assert names[0] == scenes["port"]["names"][0] + ".json"
    assert names[1:] == [n + ".json" for n in scenes["port"]["names"][N_TRAIN:]]
    assert tds.all_ids_img == jds.all_ids_img == [0, 3, 4]
    assert tds.num_val_images() == jds.num_val_images() == 1 + N_TEST
    assert not tds.train and not hasattr(tds, "all_rays")
    assert tds.prior_depths is None and tds.prior_shadows is None
    assert tds.alt_envelope() == jds.alt_envelope()


@pytest.mark.parametrize("utm", [True, False])
@pytest.mark.parametrize("i", range(1 + N_TEST))
def test_get_val_sample_matches(scenes, utm, i):
    tds, jds = _pair(scenes, "val", utm=utm)
    got, want = tds.get_val_sample(i), jds.get_val_sample(i)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["rays"], want["rays"], **GEO_TOL)
    assert got["rays"].dtype == want["rays"].dtype == np.float32
    np.testing.assert_array_equal(got["rgbs"], want["rgbs"])
    np.testing.assert_array_equal(got["ts"], want["ts"])
    assert got["ts"].dtype == want["ts"].dtype and not got["ts"].any()
    for key in ("h", "w", "src_id", "idx", "img_idx"):
        assert got[key] == want[key], key
    assert got["rays"].shape == (SIZE * SIZE, 11) and (got["h"], got["w"]) == (SIZE, SIZE)


def test_the_probe_is_the_first_train_view(scenes):
    """val[0] renders the rays and colours of the train pool's image 0."""
    tds, _ = _pair(scenes, "val")
    train, _ = _pair(scenes, "train")
    probe = tds.get_val_sample(0)
    n = SIZE * SIZE
    np.testing.assert_array_equal(probe["rays"], train.all_rays[:n])
    np.testing.assert_array_equal(probe["rgbs"], train.all_rgbs[:n])


def _ragged(pkg, shapes):
    """A dataset of the package with only what the index algebra reads:
    views of the given (h, w), their rays' image ids."""
    ds = object.__new__(pkg.SatelliteDataset)
    ds.all_img_shapes = np.asarray(shapes, np.int64)
    ds.all_ids_img = np.concatenate([np.full((h * w, 1), t, np.int32)
                                     for t, (h, w) in enumerate(shapes)])
    return ds


@pytest.fixture(scope="module", params=["scene", "ragged"])
def pools(scenes, request):
    """The scene's train pools (three 16 x 16 views) or views of three
    sizes."""
    if request.param == "scene":
        return _pair(scenes, "train")
    shapes = [(SIZE, SIZE), (SIZE + 3, SIZE - 5), (SIZE - 4, SIZE + 6)]
    return _ragged(tsat, shapes), _ragged(jsat, shapes)


def test_ray_and_pixel_index_algebra_matches(pools):
    tds, jds = pools
    shapes = tds.all_img_shapes
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, N_TRAIN, 50)
    rows = (rng.random(50) * shapes[imgs, 0]).astype(np.int64)
    cols = (rng.random(50) * shapes[imgs, 1]).astype(np.int64)
    np.testing.assert_array_equal(tds.first_ray_idx_of_img(imgs), jds.first_ray_idx_of_img(imgs))
    idx = tds.ray_index_from_colrow(cols, rows, imgs)
    np.testing.assert_array_equal(idx, jds.ray_index_from_colrow(cols, rows, imgs))
    for got, want, ref in zip(tds.colrow_from_ray_index(idx), jds.colrow_from_ray_index(idx),
                              (cols, rows, imgs)):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref)
    assert tds.first_ray_idx_of_img(2) == jds.first_ray_idx_of_img(2) == shapes[:2].prod(1).sum()


@pytest.mark.parametrize("at,img,size", [
    ("top_left", 0, 3),           # a corner: the patch clamped into the image
    ("bottom_right", 2, 4),       # the other corner, an even size
    ("interior", 1, 5),
    ("left_bottom", 1, 4),        # near two borders
    ("interior", 2, 0)])          # patch size 0: the index itself
def test_patch_indices_match(pools, at, img, size):
    tds, jds = pools
    h, w = (int(x) for x in tds.all_img_shapes[img])
    col, row = {"top_left": (0, 0), "bottom_right": (w - 1, h - 1),
                "interior": (w // 2, h // 2), "left_bottom": (1, h - 2)}[at]
    idx = int(tds.ray_index_from_colrow(col, row, img))
    got, want = tds.patch_indices(idx, size), jds.patch_indices(idx, size)
    np.testing.assert_array_equal(got, want)
    if size == 0:
        assert int(got) == idx
        return
    assert got.shape == (size * size,)
    c, r, i = tds.colrow_from_ray_index(got)
    assert (i == img).all() and c.min() >= 0 and r.min() >= 0 and c.max() < w and r.max() < h
    assert c.max() - c.min() == size - 1 and r.max() - r.min() == size - 1
    assert (col in c) and (row in r)
