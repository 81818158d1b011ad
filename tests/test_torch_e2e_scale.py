"""The production-scale runs of eonerf_code_tpu_torch/e2e.py at a tiny size
on the CPU: their TrainConfigs and scenes against the JAX package's
scripts/run_production_scale.py and scripts/run_tall_scale.py (captured
from the scripts themselves, field by field, but steps_per_call), and a run
split in two by the resume against an unbroken one: the resumed command
skips the milestones already passed and ends in the same state, bit for
bit."""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch
from torch_fixtures import one_thread  # noqa: F401

from eonerf_code_tpu.config import TrainConfig as JaxTrainConfig
from eonerf_code_tpu_torch import e2e
from eonerf_code_tpu_torch.data.synthetic import SyntheticSceneSpec
from eonerf_code_tpu_torch.train.checkpoints import latest_checkpoint, restore_checkpoint

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = {"production": "run_production_scale.py", "tall": "run_tall_scale.py"}
# the sizes and steps this test cuts: 2 views of 32x32, a 2x32 trunk
TINY_SCENE = dict(n_views=2, n_test_views=1, img_size=32, n_buildings=2)
# the grid (32^3 cells) updated every step, so its state and the gate's
# history cross the split (the tightening gate itself needs a stable history
# a few steps cannot build)
TINY = dict(net_depth=2, net_width=32, batch_size=256, n_samples=16, chunk=1024, n_grid=32,
            occ_update_every=1)
TINY_STEPS = 9


class _Captured(Exception):
    pass


def _jax_script_config(mode, workdir, monkeypatch):
    """(TrainConfig, SyntheticSceneSpec) that the JAX script builds, caught
    at its Trainer; its scene generation stubbed."""
    spec = importlib.util.spec_from_file_location(f"_jax_{mode}_script",
                                                  REPO / "scripts" / SCRIPTS[mode])
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    seen = {}

    def fake_scene(root, scene_spec):
        seen["spec"] = scene_spec
        return {"root_dir": root, "img_dir": f"{root}/images", "gt_dir": f"{root}/truth",
                "aoi_id": "SYN_TEST"}

    def fake_trainer(cfg):
        seen["cfg"] = cfg
        raise _Captured

    monkeypatch.setattr(script, "generate_scene", fake_scene)
    monkeypatch.setattr(script, "Trainer", fake_trainer)
    with pytest.raises(_Captured):
        script.main(workdir, SCALE_STEPS[mode])
    return seen["cfg"], seen["spec"]


SCALE_STEPS = {"production": 20000, "tall": 16666}


@pytest.mark.parametrize("mode", sorted(SCRIPTS))
def test_configs_match_the_jax_scripts(mode, tmp_path, monkeypatch):
    workdir = str(tmp_path)
    jax_cfg, jax_spec = _jax_script_config(mode, workdir, monkeypatch)
    root = f"{workdir}/scene"
    scene = {"root_dir": root, "img_dir": f"{root}/images", "gt_dir": f"{root}/truth",
             "aoi_id": "SYN_TEST"}
    port = dataclasses.asdict(e2e.scale_config(mode, scene, workdir, SCALE_STEPS[mode]))
    want = dataclasses.asdict(jax_cfg)
    assert set(want) - set(port) == {"steps_per_call"}
    assert set(port) <= set(want)
    assert {k: port[k] for k in port} == {k: want[k] for k in port}
    assert dataclasses.asdict(SyntheticSceneSpec(**e2e.SCALE_RUNS[mode][0])) == \
        dataclasses.asdict(jax_spec)
    assert e2e.SCALE_RUNS[mode][2] == SCALE_STEPS[mode]
    assert isinstance(jax_cfg, JaxTrainConfig)


def _same(a, b, path="state"):
    """Raise on the first leaf where two checkpoint states differ."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b or (isinstance(a, float) and np.isnan(a) and np.isnan(b)), path


def _run(mode, workdir, **kw):
    overrides = dict(TINY)
    if mode == "tall":          # the tall run keeps the sampler's auto rule
        overrides = {k: v for k, v in TINY.items() if not k.startswith("occ_")}
    return e2e.scale_run(mode, str(workdir), TINY_STEPS, device="cpu", scene_spec=TINY_SCENE,
                         log_every=10 ** 9, **kw, **overrides)


class _Killed(Exception):
    pass


def _killed(trainer):
    raise _Killed


@pytest.mark.parametrize("mode", sorted(SCRIPTS))
def test_split_run_resumes_to_the_unbroken_state(mode, tmp_path, monkeypatch, one_thread):
    whole = _run(mode, tmp_path / "whole")
    marks = e2e.milestones(TINY_STEPS)
    exp = e2e.SCALE_RUNS[mode][3]
    with monkeypatch.context() as m:     # the process dies as the first milestone's MAE starts
        m.setattr(e2e, "view_mae", _killed)
        with pytest.raises(_Killed):
            _run(mode, tmp_path / "split")
    assert restore_checkpoint(latest_checkpoint(
        str(tmp_path / "split" / "logs" / exp)))["step"] == marks[0]
    second = _run(mode, tmp_path / "split")
    assert [m["step"] for m in whole["milestones"]] == marks
    assert second["start_step"] == marks[0]
    assert [m["step"] for m in second["milestones"]] == marks[1:]       # the first skipped
    assert second["steps"] == whole["steps"] == TINY_STEPS
    assert second["mae_m"] == whole["mae_m"] and second["psnr_db"] == whole["psnr_db"]
    assert whole["sampler"] == ("tighten" if mode == "production" else "hierarchical")
    a = restore_checkpoint(latest_checkpoint(str(tmp_path / "whole" / "logs" / exp)))
    b = restore_checkpoint(latest_checkpoint(str(tmp_path / "split" / "logs" / exp)))
    _same(a, b)
    # a third command on the finished run trains nothing and reports the MAE
    again = _run(mode, tmp_path / "split")
    assert again["milestones"] == [] and again["mae_m"] == whole["mae_m"]
