"""The bundle-adjustment export against the JAX package's:
``rpc_offset_from_scene_offset`` and ``corrected_rpc`` on a scene's RPCs
(1e-9 px), and ``export_adjusted_rpcs`` on a port run and a JAX run with
``rpc_correction`` and the same fixed non-zero offsets (the written JSON
equal within 1e-9), at two image downscales; a run without offsets
raises. Each package generates its own copy of one scene (3 train views,
1 test view, 32 x 32, an RPC bias of 2 px); no field is trained."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eonerf_code_tpu.config import TrainConfig as JaxConfig
from eonerf_code_tpu.data import satellite as jsat
from eonerf_code_tpu.data import synthetic as jsyn
from eonerf_code_tpu.eval.export import export_adjusted_rpcs as jax_export
from eonerf_code_tpu.geo import bundle_adjust as jba
from eonerf_code_tpu.train import loop as jloop
from eonerf_code_tpu_torch.config import TrainConfig
from eonerf_code_tpu_torch.data import satellite as tsat
from eonerf_code_tpu_torch.data import synthetic as tsyn
from eonerf_code_tpu_torch.eval.export import export_adjusted_rpcs
from eonerf_code_tpu_torch.geo import bundle_adjust as tba
from eonerf_code_tpu_torch.train import loop as tloop

PX_TOL = 1e-9
N_VIEWS = 3
OFFSETS = np.array([[0.004, -0.003, 0.001], [-0.002, 0.005, -0.004], [0.006, 0.001, 0.002]],
                   np.float32)
CFG = dict(net_depth=2, net_width=16, n_samples=8, sc_n_samples=8, sampler="uniform",
           occ_enabled=False, batch_size=128, val_freq=10 ** 9, seed=5)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("export")
    spec = dict(n_views=N_VIEWS, n_test_views=1, img_size=32, dsm_resolution=4.0,
                rpc_bias_px=2.0, seed=4)
    return {"jax": jsyn.generate_scene(str(tmp / "jax_scene"), jsyn.SyntheticSceneSpec(**spec)),
            "port": tsyn.generate_scene(str(tmp / "port_scene"), tsyn.SyntheticSceneSpec(**spec)),
            "tmp": tmp}


@pytest.mark.parametrize("south", [False, True])
def test_rpc_offset_matches(scenes, south):
    """Each train view's RPC and a few offsets, at two reference altitudes."""
    info = scenes["port"]
    ds = tsat.SatelliteDataset(info["root_dir"], info["img_dir"], split="train")
    scene = ds.scene
    rng = np.random.default_rng(2)
    for path, rpc in zip(ds.json_files, ds.all_rpcs):
        jrpc = jsat.RPCModel(jsat.read_json(path)["rpc"])
        for offset in rng.uniform(-0.01, 0.01, (3, 3)):
            for alt in (0.0, 12.5):
                args = (offset, scene.scene_scale, scene.scene_offset, scene.utm_zonestring)
                got = tba.rpc_offset_from_scene_offset(rpc, *args, south=south, alt=alt)
                want = jba.rpc_offset_from_scene_offset(jrpc, *args, south=south, alt=alt)
                np.testing.assert_allclose(got, want, rtol=0, atol=PX_TOL)
                assert max(abs(got[0]), abs(got[1])) > 1e-3
        corr = tba.corrected_rpc(rpc, offset, *args[1:], south=south)
        jcorr = jba.corrected_rpc(jrpc, offset, *args[1:], south=south)
        assert (corr.col_offset, corr.row_offset) != (rpc.col_offset, rpc.row_offset)
        np.testing.assert_allclose([corr.col_offset, corr.row_offset],
                                   [jcorr.col_offset, jcorr.row_offset], rtol=0, atol=PX_TOL)


def _runs(scenes, name, downscale):
    """(port run dir, JAX run dir) with rpc_correction and OFFSETS."""
    tmp = scenes["tmp"]
    jinfo, pinfo = scenes["jax"], scenes["port"]
    kw = dict(CFG, exp_name=name, rpc_correction=True, img_downscale=downscale)
    jtr = jloop.Trainer(JaxConfig(root_dir=jinfo["root_dir"], img_dir=jinfo["img_dir"],
                                  logs_dir=str(tmp / "jax_logs"), **kw))
    params = jax.tree_util.tree_map(lambda x: x, jtr.params)
    params["params"]["ray_correction_enc"]["embedding"] = jnp.asarray(OFFSETS)
    jtr.params = params
    jtr.save()
    ttr = tloop.Trainer(TrainConfig(root_dir=pinfo["root_dir"], img_dir=pinfo["img_dir"],
                                    logs_dir=str(tmp / "port_logs"), **kw), device="cpu")
    with tloop.torch.no_grad():
        ttr.field.ray_correction_enc.weight.copy_(tloop.torch.from_numpy(OFFSETS))
    ttr.save()
    return ttr.log_dir, jtr.log_dir


def _close(got, want, where=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _close(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= PX_TOL, (where, got, want)
    else:
        assert got == want, where


@pytest.mark.parametrize("downscale", [1.0, 2.0])
def test_export_matches(scenes, downscale):
    """The same offsets exported from a port run and a JAX run: the same
    views, shifts and written metadata (offsets corrected at the native
    scale, rpc_adjustment_px with the working-scale shift)."""
    port_run, jax_run = _runs(scenes, f"ba{int(downscale)}", downscale)
    tmp = scenes["tmp"] / f"exported{int(downscale)}"
    got = export_adjusted_rpcs(port_run, str(tmp / "port"))
    want = jax_export(jax_run, str(tmp / "jax"))
    assert sorted(got) == sorted(want) and len(got) == N_VIEWS
    for img_id in want:
        with open(got[img_id]["path"]) as f, open(want[img_id]["path"]) as g:
            meta, jmeta = json.load(f), json.load(g)
        _close(meta, jmeta, img_id)
        for k in ("d_col", "d_row"):
            assert abs(got[img_id][k] - want[img_id][k]) <= PX_TOL
        assert abs(got[img_id]["d_col"]) + abs(got[img_id]["d_row"]) > 1e-3
        adj = meta["rpc_adjustment_px"]
        assert adj["d_col"] == pytest.approx(adj["working_scale_d_col"] * downscale, abs=1e-12)
        with open(os.path.join(scenes["port"]["root_dir"], img_id + ".json")) as f:
            orig = json.load(f)["rpc"]
        assert meta["rpc"]["col_offset"] == pytest.approx(orig["col_offset"] - adj["d_col"],
                                                          abs=1e-9)
        assert meta["rpc"]["col_num"] == orig["col_num"]


def test_export_without_offsets_raises(scenes):
    pinfo = scenes["port"]
    tr = tloop.Trainer(TrainConfig(root_dir=pinfo["root_dir"], img_dir=pinfo["img_dir"],
                                   logs_dir=str(scenes["tmp"] / "port_logs"), exp_name="noba",
                                   **CFG), device="cpu")
    tr.save()
    with pytest.raises(ValueError, match="rpc_correction"):
        export_adjusted_rpcs(tr.log_dir, str(scenes["tmp"] / "noba_out"))
