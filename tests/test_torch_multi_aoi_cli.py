"""The port's multi-AOI command line (train/multi.py) against the JAX
package's, on two generated compact scenes (3 views of 32 x 32, as
tests/test_multi_aoi_parity.py), on the CPU:

- (h) the same argv gives each scene's opts.json the JAX CLI's resolved
  keys (sampler, sample counts, occupancy flags, backend); the per-scene
  run directories load through the port's ``load_run`` and evaluate to a
  finite DSM MAE; the argument errors are the JAX CLI's; pod resume
  through the flags (4 + 4 steps against 8) gives the same bits;
- (i) ``--scene_axis 2`` over two gloo ranks (one spawn for the file):
  each scene's parameters, pod checkpoints and logged losses have the bits
  of ``--scene_axis 1``.
"""

import json
import os

import numpy as np
import pytest
import torch

from eonerf_code_tpu_torch.config import TrainConfig
from eonerf_code_tpu_torch.data.synthetic import SyntheticSceneSpec, generate_scene
from eonerf_code_tpu_torch.eval.run import eval_eonerf, load_occ_grid, load_run
from eonerf_code_tpu_torch.train import checkpoints as ckpt_lib
from eonerf_code_tpu_torch.train.multi import _split, main_multi_train, parse_args

AOIS = ("SYN_320", "SYN_321")
# opts.json's keys that the CLI resolves from its flags and the scenes
RESOLVED = ("sampler", "n_samples", "n_importance", "sc_n_samples", "occ_enabled",
            "occ_tighten", "occ_tighten_start_step", "n_grid", "use_pallas", "bwd_acts",
            "aoi_id", "exp_name", "batch_size", "max_train_steps", "net_depth", "net_width",
            "compute_dtype", "rpc_correction", "init_dsm_path", "lr", "lr_decay_steps", "seed",
            "freq_reg_start_step", "freq_reg_end_step")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    return [generate_scene(str(tmp_path_factory.mktemp(f"cli_aoi{i}")),
                           SyntheticSceneSpec(n_views=3, n_test_views=1, img_size=32,
                                              seed=30 + i), aoi_id=aoi)
            for i, aoi in enumerate(AOIS)]


def _argv(infos, logs, exp, steps, *extra):
    return ["--root_dirs", ",".join(i["root_dir"] for i in infos),
            "--img_dirs", ",".join(i["img_dir"] for i in infos),
            "--gt_dirs", ",".join(i["gt_dir"] for i in infos),
            "--aoi_ids", ",".join(AOIS), "--logs_dir", str(logs), "--exp_name", exp,
            "--max_train_steps", str(steps), "--batch_size", "64", "--fc_layers", "2",
            "--fc_units", "32", "--log_every", "2", *extra]


SAMPLERS = {
    "auto": ["--n_samples", "12", "--n_grid", "16", "--first_shadow_step", "1"],
    "hierarchical": ["--n_samples", "16", "--sampler", "hierarchical",
                     "--first_shadow_step", str(10 ** 9)],
    "explicit_importance": ["--n_samples", "16", "--sampler", "uniform", "--n_importance", "4",
                            "--first_shadow_step", str(10 ** 9)],
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_opts_match_the_jax_cli(scenes, tmp_path, capsys, name):
    """(h) Two steps through each CLI: the resolved keys of every scene's
    opts.json, the printed sampler line of auto, the checkpoints' grids and
    gate sidecars (never open in 2 steps: eval samples untightened)."""
    from eonerf_code_tpu.train.multi import main_multi_train as jax_main

    argv = _argv(scenes, tmp_path / "port", "pod", 2, *SAMPLERS[name])
    stats = main_multi_train(argv, device="cpu")
    out = capsys.readouterr().out
    # one device: the axes change no resolved key, and a 1 x 1 mesh compiles
    # faster than the 2 x 4 of the 8 virtual devices
    jax_main(_argv(scenes, tmp_path / "jax", "pod", 2, *SAMPLERS[name], "--scene_axis", "1",
                   "--data_axis", "1"))
    assert stats["steps"] == 2 and stats["scenes"] == 2
    for aoi in AOIS:
        got = json.loads((tmp_path / "port" / "pod" / aoi / "opts.json").read_text())
        want = json.loads((tmp_path / "jax" / "pod" / aoi / "opts.json").read_text())
        assert {k: got[k] for k in RESOLVED} == {k: want[k] for k in RESOLVED}, aoi
    if name != "auto":
        return
    assert "sampler=auto -> tighten" in out
    for aoi in AOIS:
        run_dir = str(tmp_path / "port" / "pod" / aoi)
        cfg = TrainConfig.load(os.path.join(run_dir, "opts.json"))
        assert cfg.sampler == "tighten" and cfg.occ_tighten and cfg.n_grid == 16
        ck = ckpt_lib.latest_checkpoint(run_dir)
        occ = ckpt_lib.restore_checkpoint(ck)["occ"]
        assert occ["occs"].shape == (16 ** 3,) and occ["binaries"].shape == (16, 16, 16)
        with open(os.path.join(ck, "occ_sampling.json")) as f:
            sidecar = json.load(f)
        assert sidecar["tighten_active"] is False
        assert len(sidecar["frac_hist"]) == 1
        assert all(isinstance(x, float) for x in sidecar["frac_hist"])
        assert load_occ_grid(run_dir, cfg, device="cpu") is None


def test_runs_load_and_evaluate(scenes, tmp_path):
    """(h) Each scene's run directory loads through load_run (its own
    parameters, the per-sample backend it trained with) and eval_eonerf
    gives a finite registered DSM MAE."""
    main_multi_train(_argv(scenes, tmp_path, "pod_ev", 4, "--n_samples", "12",
                           "--first_shadow_step", "2"), device="cpu")
    params = []
    for info, aoi in zip(scenes, AOIS):
        run_dir = str(tmp_path / "pod_ev" / aoi)
        assert os.path.exists(os.path.join(run_dir, "metrics.jsonl"))
        cfg, render_field, field = load_run(run_dir, device="cpu")
        assert cfg.aoi_id == aoi and cfg.exp_name == aoi and cfg.use_pallas is False
        assert render_field is field and (cfg.net_depth, cfg.net_width) == (2, 32)
        state = field.state_dict()
        assert all(bool(torch.isfinite(v).all()) for v in state.values())
        params.append(state["trunk.hidden_0.weight"])
        out = eval_eonerf(f"pod_ev/{aoi}", str(tmp_path), str(tmp_path / "eval"), dsm=True,
                          gt_dir=info["gt_dir"], dsm_resolution=2.0, device="cpu")
        assert os.path.exists(out["dsm_path"]) and np.isfinite(out["mae"])
    assert not torch.equal(params[0], params[1])


BAD_ARGV = {
    "img_count": ["--root_dirs", "a,b", "--img_dirs", "onlyone", "--exp_name", "x"],
    "duplicate_names": ["--root_dirs", "/p/s1,/q/s1", "--img_dirs", "/p/i,/q/i",
                        "--exp_name", "x"],
    "gt_count": ["--root_dirs", "a,b", "--img_dirs", "i,j", "--gt_dirs", "g", "--exp_name", "x"],
    "aoi_count": ["--root_dirs", "a,b", "--img_dirs", "i,j", "--aoi_ids", "A",
                  "--exp_name", "x"],
    "prior_slots": ["--root_dirs", "a,b", "--img_dirs", "i,j", "--init_dsm_paths", "d.tif",
                    "--exp_name", "x"],
}


@pytest.mark.parametrize("name", sorted(BAD_ARGV))
def test_argument_errors_match_the_jax_cli(name):
    """(h) The same SystemExit, with the same message, before any data."""
    from eonerf_code_tpu.train.multi import main_multi_train as jax_main

    with pytest.raises(SystemExit) as want:
        jax_main(BAD_ARGV[name])
    with pytest.raises(SystemExit) as got:
        main_multi_train(BAD_ARGV[name], device="cpu")
    assert str(got.value) == str(want.value)


def test_default_aoi_ids_from_basenames():
    args = parse_args(["--root_dirs", "/data/JAX_068,/data/JAX_004", "--img_dirs", "/i1,/i2",
                       "--exp_name", "e"])
    assert _split(args.aoi_ids) == [] and args.use_pallas == "auto"


def _states(logs, exp):
    return {aoi: ckpt_lib.restore_checkpoint(ckpt_lib.latest_checkpoint(
        os.path.join(str(logs), exp, aoi))) for aoi in AOIS}


def test_pod_resume_through_the_flags(scenes, tmp_path):
    """(h) --save_freq 4 to step 4, then --resume to 8: each scene's
    parameters are an uninterrupted 8-step run's, bit for bit; the resumed
    run counts only its own steps, a complete one none; --resume without a
    checkpoint starts afresh."""
    def run(exp, steps, *extra):
        return main_multi_train(_argv(scenes, tmp_path, exp, steps, "--n_samples", "12",
                                      "--n_grid", "16", "--first_shadow_step", "3", *extra),
                                device="cpu")

    assert run("fresh", 2, "--resume")["steps_run"] == 2
    run("full", 8)
    run("res", 4, "--save_freq", "4")
    assert os.path.isdir(tmp_path / "res" / "_pod" / "ckpts" / "epoch=4")
    resumed = run("res", 8, "--resume")
    assert resumed["steps"] == 8 and resumed["steps_run"] == 4
    done = run("res", 8, "--resume")
    assert done["steps_run"] == 0 and done["rays_per_sec"] == 0.0
    full, res = _states(tmp_path, "full"), _states(tmp_path, "res")
    for aoi in AOIS:
        assert res[aoi]["step"] == 8
        for k, v in full[aoi]["params"].items():
            assert torch.equal(v, res[aoi]["params"][k]), (aoi, k)
        for k in ("occs", "binaries"):
            assert torch.equal(full[aoi]["occ"][k], res[aoi]["occ"][k]), (aoi, k)


SPLIT_EXTRA = ("--n_samples", "12", "--n_grid", "16", "--occ_tighten_start_step", "0",
               "--first_shadow_step", "2", "--save_freq", "2")


@pytest.fixture(scope="module")
def scene_axis_two(scenes, tmp_path_factory):
    """(i) The file's one spawn: --scene_axis 2, two CPU ranks over gloo,
    one scene each; and the same argv at --scene_axis 1 in this process.
    Every run at one thread (a rank): the CPU's matrix products split their
    sums by the thread count, so the bits depend on it."""
    logs = tmp_path_factory.mktemp("split")
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(2)        # launch gives each of the two ranks one
        two = main_multi_train(_argv(scenes, logs, "two", 4, *SPLIT_EXTRA,
                                     "--scene_axis", "2"), device="cpu")
        torch.set_num_threads(1)
        one = main_multi_train(_argv(scenes, logs, "one", 4, *SPLIT_EXTRA,
                                     "--scene_axis", "1"), device="cpu")
    finally:
        torch.set_num_threads(threads)
    return logs, one, two


def _logged(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [(r["step"], r["value"]) for r in map(json.loads, f) if r["tag"] == "train/loss"]


def test_scene_axis_two_is_scene_axis_one(scene_axis_two):
    """(i) Each scene's run-dir parameters and grid, both pod checkpoints
    (every scene's stacked parameters, Adam state, grids, gate ring) and the
    logged losses: the same bits at --scene_axis 2 as at 1."""
    logs, one, two = scene_axis_two
    assert one["steps_run"] == two["steps_run"] == 4
    a, b = _states(logs, "one"), _states(logs, "two")
    for aoi in AOIS:
        for k, v in a[aoi]["params"].items():
            assert torch.equal(v, b[aoi]["params"][k]), (aoi, k)
        for k in ("occs", "binaries"):
            assert torch.equal(a[aoi]["occ"][k], b[aoi]["occ"][k]), (aoi, k)
        assert _logged(logs / "one" / aoi) == _logged(logs / "two" / aoi)
    for step in (2, 4):
        pa, pb = (ckpt_lib.restore_checkpoint(str(logs / e / "_pod" / "ckpts" / f"epoch={step}"))
                  for e in ("one", "two"))
        assert pa["step"] == pb["step"] == step
        for part in ("params", "occ"):
            for k, v in pa[part].items():
                assert torch.equal(v, pb[part][k]), (step, part, k)
        for part in ("mu", "nu"):
            for k, v in pa["opt_state"][part].items():
                assert torch.equal(v, pb["opt_state"][part][k]), (step, part, k)
        assert np.array_equal(pa["gate"]["frac_hist"].numpy(), pb["gate"]["frac_hist"].numpy(),
                              equal_nan=True)
