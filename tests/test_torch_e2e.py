"""The port's end-to-end runs (eonerf_code_tpu_torch/e2e.py) at a toy size
on the CPU: the quality runs train a few steps and score a finite
registered MAE, the bundle-adjustment arms report one learned offset row
per biased view, the annealed arm logs its ramp; and the runs' scenes and
configurations are the JAX scripts' (scripts/run_synthetic_e2e.py,
scripts/ab_bundle_adjust.py), caught where they build them. No field is
trained to an MAE here: that is chip_smoke.py's phase quality."""

import importlib
import json
import math
import os
import sys

import pytest

from eonerf_code_tpu_torch import e2e

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY_SCENE = dict(n_views=3, n_test_views=1, img_size=16, dsm_resolution=4.0)
TOY = dict(net_depth=2, net_width=32, batch_size=128, n_samples=8, chunk=256,
           compute_dtype="float32", first_shadow_step=2)


def _script(name):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


class _Caught(Exception):
    pass


def test_synthetic_toy(tmp_path):
    out = e2e.synthetic(str(tmp_path), 3, ("A", "C"), "cpu", TOY_SCENE, **TOY)
    assert sorted(out) == ["A", "C"]
    for res in out.values():
        assert res["steps"] == 3 and math.isfinite(res["mae_m"]) and res["mae_m"] > 0
        assert all(abs(v) <= 5 for v in res["shift"])
        assert math.isfinite(res["final_loss"]) and res["rays_per_s"] > 0


def test_bundle_adjust_toy(tmp_path):
    """Both arms; the annealed one anneals to steps // 2, logs train/pe_alpha
    up to the PE degree, and reports one offset row per biased view."""
    out = e2e.bundle_adjust(str(tmp_path), 4, 3.0, tuple(e2e.ARMS), "cpu",
                            dict(TOY_SCENE, seed=3), **TOY)
    assert sorted(out) == ["biased", "biased+ba"]
    assert "offsets" not in out["biased"]
    offsets = out["biased+ba"]["offsets"]
    assert len(offsets["views"]) == TOY_SCENE["n_views"]
    assert math.isfinite(offsets["corr"]) and offsets["sign"] in (-1.0, 1.0)
    assert offsets["median_resid_px"] >= 0
    with open(tmp_path / "logs" / "ba_biased+ba" / "opts.json") as f:
        opts = json.load(f)
    assert opts["rpc_correction"] and opts["freq_reg_end_step"] == 2
    with open(tmp_path / "logs" / "ba_biased+ba" / "metrics.jsonl") as f:
        alpha = [r["value"] for r in map(json.loads, f) if r["tag"] == "train/pe_alpha"]
    assert alpha == [0.0]   # logged at step 0 (log_every 100)


def test_runs_are_the_jax_pin(tmp_path, monkeypatch):
    """Run A's TrainConfig is the JAX demo's (scripts/run_synthetic_e2e.py)
    on the same scene spec, seed 0 as the convergence pin's; B-D change only
    the width, dtype, int8 tier and backward."""
    from eonerf_code_tpu.config import TrainConfig as JaxConfig

    mod = _script("run_synthetic_e2e")
    caught = {}

    def fake_scene(out, spec):
        caught["spec"] = spec
        return {"root_dir": "r", "img_dir": "i", "gt_dir": "g", "aoi_id": "SYN_068"}

    def fake_trainer(cfg):
        caught["cfg"] = cfg
        raise _Caught

    monkeypatch.setattr(mod, "generate_scene", fake_scene)
    monkeypatch.setattr(mod, "Trainer", fake_trainer)
    with pytest.raises(_Caught):
        mod.main(str(tmp_path), 2000)
    jcfg = caught["cfg"]
    assert {k: getattr(caught["spec"], k) for k in e2e.SCENE} == e2e.SCENE
    for k, v in e2e.PIN.items():
        assert getattr(jcfg, k) == (v if k != "seed" else JaxConfig().seed), k
    assert e2e.PIN["seed"] == 0
    for run, over in e2e.RUNS.items():
        assert set(over) <= {"net_width", "compute_dtype", "trunk_quant", "bwd_acts"}, run


def test_arms_are_the_ab_script(tmp_path, monkeypatch):
    """The bundle-adjustment scene is ab_bundle_adjust.py's small base with
    its default bias, and biased+ba anneals to steps // 2 as its small arm."""
    mod = _script("ab_bundle_adjust")
    specs = []

    def fake_scene(out, spec):
        specs.append(spec)
        raise _Caught

    monkeypatch.setattr(mod, "generate_scene", fake_scene)
    with pytest.raises(_Caught):
        mod.main(str(tmp_path), "40", "3.0", "biased+ba", "--small")
    spec = specs[0]
    assert {k: getattr(spec, k) for k in e2e.BA_SCENE} == e2e.BA_SCENE
    assert spec.rpc_bias_px == e2e.BIAS_PX
    assert e2e.arm_overrides("biased+ba", 40)["freq_reg_end_step"] == 20
    assert "freq_reg_end_step" not in e2e.arm_overrides("biased", 40)


def test_main_parses_its_arguments(monkeypatch):
    seen = []
    monkeypatch.setattr(e2e, "synthetic", lambda *a: seen.append(("synthetic", a)))
    monkeypatch.setattr(e2e, "bundle_adjust", lambda *a: seen.append(("bundle_adjust", a)))
    e2e.main(["synthetic", "w", "30", "B", "D", "--device", "cpu"])
    e2e.main(["bundle_adjust"])
    e2e.main(["bundle_adjust", "w", "10", "2.5", "biased"])
    assert seen == [("synthetic", ("w", 30, ("B", "D"), "cpu")),
                    ("bundle_adjust", ("logs/e2e", 2000, 3.0, ("biased", "biased+ba"), "cuda")),
                    ("bundle_adjust", ("w", 10, 2.5, ("biased",), "cuda"))]
    with pytest.raises(SystemExit):
        e2e.main(["train"])
