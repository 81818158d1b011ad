"""import_jax_run.py and the port's checkpoint gate: a JAX trainer's
checkpoints, with the tightening gate open and closed, with and without
their occ_sampling.json sidecars, turned into a port run directory, give
the port's ``load_run`` the JAX parameters and its ``load_occ_grid`` the
JAX ``load_occ_grid``'s answer in each case (tests/test_occ_tighten.py's
four cases). The port's own checkpoints give the same answers without
their sidecars (the gate's verdict rides ``state["gate"]``), a checkpoint
with neither verdict counts as open, and the trainer refuses to resume
from an imported checkpoint. The JAX trainer is built on a generated
scene (2 train views, 1 test view, 24 x 24); no field is trained."""

import contextlib
import importlib.util
import io
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eonerf_code_tpu.config import TrainConfig as JaxConfig
from eonerf_code_tpu.data import synthetic as jsyn
from eonerf_code_tpu.eval import run as jrun
from eonerf_code_tpu.train import loop as jloop
from eonerf_code_tpu_torch.config import TrainConfig
from eonerf_code_tpu_torch.eval import run as trun
from eonerf_code_tpu_torch.interop.jax_params import jax_params_from_field_state
from eonerf_code_tpu_torch.train import checkpoints as ckpt_lib
from eonerf_code_tpu_torch.train import loop as tloop

REPO = pathlib.Path(__file__).resolve().parent.parent
SIZE, GRID = 24, 16
CFG = dict(net_depth=2, net_width=32, n_samples=16, sc_n_samples=16, batch_size=128,
           occ_enabled=True, n_grid=GRID, occ_tighten=True, occ_tighten_start_step=1,
           val_freq=10 ** 9, seed=3)
OPEN_HIST = [0.9375, 0.875, 0.75] + [0.5] * 6   # dyadic: the JAX ring holds float32
CLOSED_HIST = [0.5, 0.25]
# (tag, gate open, sidecar kept)
CASES = [("open", True, True), ("closed", False, True), ("open_noside", True, False),
         ("closed_noside", False, False)]


def _importer():
    spec = importlib.util.spec_from_file_location("import_jax_run", REPO / "import_jax_run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _grid_arrays():
    rng = np.random.default_rng(7)
    occs = rng.random(GRID ** 3).astype(np.float32)
    return occs, (occs > 0.5).reshape((GRID,) * 3)


def _set_gate(tr, gate_open):
    tr.step = 2
    tr._occ_frac_hist = list(OPEN_HIST if gate_open else CLOSED_HIST)
    tr._entropy_hist = [0.25]
    assert (tr._occ_for_sampling() is not None) == gate_open


def _save_cases(tr, sidecar_name):
    for tag, gate_open, keep in CASES:
        _set_gate(tr, gate_open)
        path = tr.save(epoch_tag=tag)
        if not keep:
            os.remove(os.path.join(path, sidecar_name))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX trainer, its config, the imported port run dir, what the
    importer printed)."""
    tmp = tmp_path_factory.mktemp("import")
    spec = dict(n_views=2, n_test_views=1, img_size=SIZE)
    jinfo = jsyn.generate_scene(str(tmp / "jax_scene"), jsyn.SyntheticSceneSpec(**spec))
    jcfg = JaxConfig(root_dir=jinfo["root_dir"], img_dir=jinfo["img_dir"],
                     logs_dir=str(tmp / "jax_logs"), exp_name="run", **CFG)
    jtr = jloop.Trainer(jcfg)
    occs, binaries = _grid_arrays()
    jtr.occ_grid = jtr.occ_grid.replace(occs=jnp.asarray(occs), binaries=jnp.asarray(binaries))
    _save_cases(jtr, "occ_sampling.json")
    _set_gate(jtr, False)
    jtr.save()                                  # epoch=0
    port_run = str(tmp / "port_logs" / "run")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        tags = _importer().main([jtr.log_dir, port_run])
    assert sorted(tags) == sorted(["0"] + [c[0] for c in CASES])
    return jtr, jcfg, port_run, printed.getvalue()


def test_import_carries_the_parameters(runs):
    """load_run on the imported run: the JAX parameters (the state_dict
    carried back to a flax tree equals the JAX tree), step and epoch, the
    decoded gate, no optimizer state."""
    jtr, _, port_run, _ = runs
    cfg, render_field, field = trun.load_run(port_run, epoch_nb=0, device="cpu")
    assert render_field is field and field.net_depth == 2 and field.net_width == 32
    got = jax_params_from_field_state(field.state_dict())
    want = jax.tree_util.tree_map(np.asarray, jtr.params)
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_got) == len(flat_want)
    for path, a in flat_got:
        np.testing.assert_array_equal(a, flat_want[path], err_msg=str(path))
    state = ckpt_lib.restore_checkpoint(os.path.join(port_run, "ckpts", "epoch=open"))
    assert "opt_state" not in state and "rng" not in state
    assert (state["step"], state["epoch"]) == (2, 0)
    # the JAX ring keeps the last 8 of the 9 entries
    assert state["gate"] == {"frac_hist": OPEN_HIST[-8:], "entropy_hist": [0.25],
                             "tighten_active": True}
    with open(os.path.join(port_run, "opts.json")) as f, open(
            os.path.join(jtr.log_dir, "opts.json")) as g:
        assert json.load(f) == json.load(g)
    assert cfg.occ_tighten and cfg.n_grid == GRID


@pytest.mark.parametrize("tag,gate_open,keep", CASES)
def test_imported_occ_grid_matches(runs, tag, gate_open, keep):
    jtr, jcfg, port_run, _ = runs
    want = jrun.load_occ_grid(jtr.log_dir, jcfg, epoch_nb=tag)
    cfg = TrainConfig.load(os.path.join(port_run, "opts.json"))
    got = trun.load_occ_grid(port_run, cfg, epoch_nb=tag, device="cpu")
    side = os.path.join(port_run, "ckpts", f"epoch={tag}", tloop.OCC_SIDECAR)
    assert os.path.exists(side) == keep
    assert (want is None) == (got is None) == (not gate_open)
    if gate_open:
        assert got.resolution == want.resolution == GRID
        np.testing.assert_array_equal(got.occs.numpy(), np.asarray(want.occs))
        np.testing.assert_array_equal(got.binaries.numpy(), np.asarray(want.binaries))
    off = TrainConfig.load(os.path.join(port_run, "opts.json"))
    off.occ_tighten = False
    assert trun.load_occ_grid(port_run, off, epoch_nb=tag, device="cpu") is None


def _port_trainer(tmp_path, name, **kw):
    rng = np.random.default_rng(1)
    n = 48
    rays = np.zeros((n, 11), np.float32)
    rays[:, 0:2] = rng.uniform(-0.7, 0.7, (n, 2))
    rays[:, 2], rays[:, 5], rays[:, 7] = 0.99, -1.0, 2.0
    rays[:, 8:11] = np.array([0.3, 0.2, -0.93]) / np.linalg.norm([0.3, 0.2, -0.93])
    pool = {"rays": rays, "rgbs": rng.random((n, 3)).astype(np.float32),
            "ts": rng.integers(0, 2, n)}
    cfg = TrainConfig(logs_dir=str(tmp_path), exp_name=name, sampler="uniform",
                      bwd_acts="recompute", **{**CFG, "batch_size": 8}, **kw)
    return tloop.Trainer(cfg, pool, n_images=2, device="cpu")


def test_port_checkpoint_gate_is_self_contained(tmp_path):
    """The port's own checkpoints: state["gate"] carries tighten_active,
    and load_occ_grid follows it without the sidecar (the four cases); a
    checkpoint with no verdict anywhere (saved before the gate carried
    one) counts as open."""
    tr = _port_trainer(tmp_path, "native")
    occs, binaries = _grid_arrays()
    tr.occ_grid = tloop.OccupancyGrid(occs=torch.from_numpy(occs),
                                      binaries=torch.from_numpy(binaries), resolution=GRID)
    _save_cases(tr, tloop.OCC_SIDECAR)
    for tag, gate_open, keep in CASES:
        path = os.path.join(tr.log_dir, "ckpts", f"epoch={tag}")
        assert ckpt_lib.restore_checkpoint(path)["gate"]["tighten_active"] == gate_open
        assert os.path.exists(os.path.join(path, tloop.OCC_SIDECAR)) == keep
        got = trun.load_occ_grid(tr.log_dir, tr.cfg, epoch_nb=tag, device="cpu")
        assert (got is None) == (not gate_open), tag
        if gate_open:
            np.testing.assert_array_equal(got.occs.numpy(), occs)
            np.testing.assert_array_equal(got.binaries.numpy(), binaries)
    # an older checkpoint: its gate holds only the (closed) histories
    path = os.path.join(tr.log_dir, "ckpts", "epoch=closed_noside")
    state = ckpt_lib.restore_checkpoint(path)
    del state["gate"]["tighten_active"]
    torch.save(state, os.path.join(path, ckpt_lib.STATE_FILE))
    got = trun.load_occ_grid(tr.log_dir, tr.cfg, epoch_nb="closed_noside", device="cpu")
    assert got is not None
    np.testing.assert_array_equal(got.occs.numpy(), occs)


def test_resume_from_an_imported_checkpoint_raises(runs, tmp_path):
    _, _, port_run, _ = runs
    with pytest.raises(ValueError, match="imported for evaluation"):
        _port_trainer(tmp_path, "resume",
                      ckpt_path=os.path.join(port_run, "ckpts", "epoch=open"))


def test_importer_reports_dropped_keys(runs):
    """The JAX opts.json keys the port's TrainConfig does not have are
    printed (steps_per_call), and each converted checkpoint; use_pallas and
    freq_reg_start_step, dropped until the bundle-adjustment slice, and
    data_axis, dropped until the data-parallel slice, are kept."""
    out = runs[3]
    line = next(ln for ln in out.splitlines() if ln.startswith("opts.json keys"))
    for key in ("steps_per_call",):
        assert repr(key) in line, line
    for key in ("n_samples", "use_pallas", "freq_reg_start_step", "data_axis"):
        assert repr(key) not in line, line
    assert sum(ln.startswith("epoch=") for ln in out.splitlines()) == len(CASES) + 1


def test_pod_import_resumes(tmp_path):
    """import_jax_run.py --pod: a JAX multi-AOI pod checkpoint (after two
    steps, with a gate history) becomes the port's, whose restore gives the
    JAX trainer's stacked parameters, Adam count and moments, grids and gate
    history, bit for bit; train_multi_aoi_torch.py's --resume continues it
    with the flags the JAX trainer's configuration came from, and each
    scene's run directory loads through load_run."""
    from eonerf_code_tpu.data.satellite import SatelliteDataset as JaxDataset
    from eonerf_code_tpu.parallel.mesh import make_mesh
    from eonerf_code_tpu.parallel.multi_aoi import MultiAOITrainer as JaxMulti
    from eonerf_code_tpu_torch.data.satellite import SatelliteDataset
    from eonerf_code_tpu_torch.interop.jax_params import pod_states_to_jax
    from eonerf_code_tpu_torch.parallel.multi_aoi import MultiAOITrainer, unstack_params
    from eonerf_code_tpu_torch.train.multi import main_multi_train

    infos = [jsyn.generate_scene(str(tmp_path / f"aoi{i}"), jsyn.SyntheticSceneSpec(
        n_views=2, n_test_views=1, img_size=SIZE, seed=i), aoi_id=f"SYN_50{i}")
        for i in range(2)]
    kw = dict(n_samples=12, sc_n_samples=12, batch_size=64, net_depth=2, net_width=32,
              occ_enabled=True, occ_tighten=True, n_grid=GRID)
    jtr = JaxMulti([JaxDataset(i["root_dir"], i["img_dir"], split="train") for i in infos],
                   make_mesh(n_data=1, n_scene=1), **kw)
    jtr.train_steps(2, shadows=False)
    jtr._occ_frac_hist = [np.full(2, v, np.float32) for v in OPEN_HIST]
    jax_exp = tmp_path / "jax" / "pod"
    jtr.save_pod(str(jax_exp / "_pod"))
    # a scene run directory as the JAX CLI writes one (params only)
    jloop.ckpt_lib.save_checkpoint(str(jax_exp / "SYN_500"), 2, {
        "params": jax.tree_util.tree_map(lambda x: np.asarray(x[0]), jtr.params), "step": 2})
    JaxConfig(root_dir=infos[0]["root_dir"], img_dir=infos[0]["img_dir"], net_depth=2,
              net_width=32).save(str(jax_exp / "SYN_500" / "opts.json"))
    port_exp = tmp_path / "port" / "pod"
    with contextlib.redirect_stdout(io.StringIO()):
        out = _importer().main(["--pod", str(jax_exp), str(port_exp)])
    assert out == {"_pod": ["2"], "SYN_500": ["2"]}

    tr = MultiAOITrainer([SatelliteDataset(i["root_dir"], i["img_dir"], split="train")
                          for i in infos], None, device="cpu", **kw)
    tr.restore_pod(ckpt_lib.latest_checkpoint(str(port_exp / "_pod")))
    assert tr.step == 2
    state = tr.state_pytree()
    got = pod_states_to_jax(unstack_params(state["params"], 2))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jtr.params))):
        np.testing.assert_array_equal(a, b)
    adam = jtr.opt_state[0]
    np.testing.assert_array_equal(state["opt_state"]["count"].numpy(), np.asarray(adam.count))
    for part in ("mu", "nu"):
        got = pod_states_to_jax(unstack_params(state["opt_state"][part], 2))
        want = jax.tree_util.tree_map(np.asarray, getattr(adam, part))
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(state["occ"]["occs"].numpy(), np.asarray(jtr.occ_grids.occs))
    np.testing.assert_array_equal(np.stack(tr._occ_frac_hist), np.stack(jtr._occ_frac_hist))
    assert tr.occ_gate_open() == jtr.occ_gate_open()

    argv = ["--root_dirs", ",".join(i["root_dir"] for i in infos),
            "--img_dirs", ",".join(i["img_dir"] for i in infos), "--aoi_ids", "SYN_500,SYN_501",
            "--logs_dir", str(tmp_path / "port"), "--exp_name", "pod", "--max_train_steps", "4",
            "--batch_size", "64", "--n_samples", "12", "--n_grid", str(GRID),
            "--fc_layers", "2", "--fc_units", "32", "--first_shadow_step", "3", "--resume"]
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        stats = main_multi_train(argv, device="cpu")
    assert stats["steps_run"] == 2 and "resumed pod from" in printed.getvalue()
    _, _, field = trun.load_run(str(port_exp / "SYN_500"), device="cpu")
    assert all(bool(torch.isfinite(v).all()) for v in field.state_dict().values())
