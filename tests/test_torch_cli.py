"""The port's command-line interface against the JAX package's cli.py: the
same flag names and ``dest``s in the training and eval parsers, the same
TrainConfig from the same arguments, the flags the port refuses or
ignores (``--steps_per_call``) and those it now takes (``--use_pallas``,
``--freq_reg_*``, ``--data_axis``), and the two entry points end to end on
the CPU: 2 training steps of a 2 x 32 field on a generated scene (2 train
views, 1 test view, 24 x 24; GT at 2 m), then its DSM eval at one and at
two processes; ``train_eonerf_torch.py --data_axis 2 --device cpu`` (two
gloo ranks), and what data parallel refuses."""

import argparse
import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from eonerf_code_tpu import cli as jcli
from eonerf_code_tpu.eval import run as jrun
from eonerf_code_tpu_torch import cli as tcli
from eonerf_code_tpu_torch.config import TrainConfig
from eonerf_code_tpu_torch.data import synthetic as tsyn

REPO = pathlib.Path(__file__).resolve().parent.parent

ARGS = ["--root_dir", "/data/root", "--img_dir", "/data/img", "--gt_dir", "/data/gt",
        "--exp_name", "run1", "--model", "sat-nerf", "--img_downscale", "2",
        "--max_train_steps", "1000", "--fc_units", "64", "--fc_layers", "4",
        "--n_samples", "96", "--sc_n_samples", "0", "--batch_size", "2048",
        "--no_geometric_shadows", "--rpc_correction", "--ecef", "--n_grid", "64",
        "--subset_Nviews", "9", "--compute_dtype", "bfloat16", "--occ_tighten",
        "--no_occ_tighten_shadows", "--occ_tighten_start_step", "50", "--trunk_quant", "int8",
        "--bwd_acts", "recompute", "--lr_decay_steps", "300", "--first_shadow_step", "7",
        "--first_beta_step", "8", "--val_freq", "20", "--save_freq", "40", "--no_device_eval",
        "--seed", "9", "--aoi_id", "SYN_068", "--ckpt_path", "/ck/epoch=3"]


def _surface(parser):
    return sorted((tuple(a.option_strings), a.dest) for a in parser._actions)


def _jax_eval_parser(monkeypatch):
    """The parser the JAX eval_cli builds inside itself, caught at its
    parse_args (eval_eonerf stubbed)."""
    caught = []
    parse = argparse.ArgumentParser.parse_args

    def spy(self, *args, **kwargs):
        caught.append(self)
        return parse(self, *args, **kwargs)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    monkeypatch.setattr(jrun, "eval_eonerf", lambda *a, **k: {})
    jcli.eval_cli(["run"])
    return caught[-1]


def test_flag_surfaces_match(monkeypatch, capsys):
    """Every flag of both JAX parsers, with its dest, and no other."""
    assert _surface(tcli.build_parser()) == _surface(jcli.build_parser())
    assert _surface(tcli.build_eval_parser()) == _surface(_jax_eval_parser(monkeypatch))


def test_config_matches_and_round_trips(tmp_path):
    """The same arguments give the JAX TrainConfig's values for every field
    the port has; opts.json round-trips."""
    got = tcli.config_from_args(ARGS)
    want = jcli.config_from_args(ARGS)
    for f in dataclasses.fields(TrainConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    path = str(tmp_path / "opts.json")
    got.save(path)
    assert TrainConfig.load(path) == got
    assert (got.net_width, got.net_depth, got.subset_n_views) == (64, 4, 9)
    assert got.occ_tighten_shadows is False and got.device_eval is False


@pytest.mark.parametrize("extra,error,match", [
    (["--use_pallas", "false"], None, ("use_pallas", False)),
    (["--use_pallas", "true"], None, ("use_pallas", True)),
    (["--data_axis", "2"], None, ("data_axis", 2)),
    (["--data_axis", "-1"], None, ("data_axis", -1)),
    (["--freq_reg_start_step", "5"], ValueError, "END step")])
def test_refused_flags_raise(extra, error, match):
    """An annealing start without its end raises. --use_pallas, refused
    until the use_pallas slice, now sets TrainConfig.use_pallas, and
    --data_axis, refused until the data-parallel slice, TrainConfig.data_axis
    (``match``: the field and its value)."""
    if error is None:
        name, value = match
        got = getattr(tcli.config_from_args(["--root_dir", "/r", *extra]), name)
        assert got == value and type(got) is type(value)
        return
    with pytest.raises(error, match=match):
        tcli.config_from_args(["--root_dir", "/r", *extra])


def test_ignored_flags_warn(capsys):
    cfg = tcli.config_from_args(["--root_dir", "/r", "--steps_per_call", "10", "--noise_std",
                                 "0.5", "--data_axis", "1"])
    err = capsys.readouterr().err
    assert err.count("--steps_per_call 10") == 1
    assert "ignoring flag --noise_std 0.5 (dead in the reference too" in err
    assert cfg == tcli.config_from_args(["--root_dir", "/r"])
    assert capsys.readouterr().err == ""


def test_freq_reg_reaches_the_trainer(tmp_path, capsys):
    """--freq_reg_start_step and --freq_reg_end_step (refused by the trainer
    until the bundle-adjustment slice) reach it: 3 steps of bundle
    adjustment on a generated scene, annealing from step 1 to 3, write
    both to opts.json, log train/pe_alpha, and print no --rpc_correction
    warning."""
    info = tsyn.generate_scene(str(tmp_path / "scene"),
                               tsyn.SyntheticSceneSpec(n_views=2, n_test_views=1, img_size=16))
    logs = str(tmp_path / "logs")
    stats = tcli.main_train(["--root_dir", info["root_dir"], "--img_dir", info["img_dir"],
                             "--logs_dir", logs, "--exp_name", "ramp", "--max_train_steps", "3",
                             "--fc_layers", "2", "--fc_units", "32", "--n_samples", "8",
                             "--batch_size", "64", "--n_grid", "16", "--rpc_correction",
                             "--freq_reg_start_step", "1", "--freq_reg_end_step", "3",
                             "--val_freq", "1000"], device="cpu")
    assert stats["steps"] == 3
    assert "--rpc_correction without --freq_reg_end_step" not in capsys.readouterr().err
    cfg = TrainConfig.load(os.path.join(logs, "ramp", "opts.json"))
    assert (cfg.freq_reg_start_step, cfg.freq_reg_end_step, cfg.rpc_correction) == (1, 3, True)
    with open(os.path.join(logs, "ramp", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    alpha = {r["step"]: r["value"] for r in rows if r["tag"] == "train/pe_alpha"}
    assert alpha == {0: 0.0}      # main_train logs every 50 steps


def test_train_then_eval(tmp_path, capsys):
    """main_train: 2 steps write opts.json, epoch=0 (save_freq 1) and the
    final epoch=1 (the loop ends its cut epoch); eval_cli --dsm on
    that run prints the JAX eval's dict (mae, dsm_path, rdsm_path), at one
    process and at --data_axis 2 (two gloo ranks, the sweep's blocks split
    between them, the files and the printed dict from rank 0); --export_rpc
    on a run without offsets raises."""
    info = tsyn.generate_scene(str(tmp_path / "scene"),
                               tsyn.SyntheticSceneSpec(n_views=2, n_test_views=1, img_size=24))
    logs = str(tmp_path / "logs")
    stats = tcli.main_train(["--root_dir", info["root_dir"], "--img_dir", info["img_dir"],
                             "--logs_dir", logs, "--exp_name", "cli", "--max_train_steps", "2",
                             "--fc_layers", "2", "--fc_units", "32", "--n_samples", "16",
                             "--batch_size", "128", "--n_grid", "16", "--save_freq", "1",
                             "--aoi_id", info["aoi_id"], "--steps_per_call", "5"],
                            device="cpu")
    assert stats["steps"] == 2
    run = os.path.join(logs, "cli")
    assert os.path.exists(os.path.join(run, "opts.json"))
    assert sorted(os.listdir(os.path.join(run, "ckpts"))) == ["epoch=0", "epoch=1"]
    capsys.readouterr()
    eval_args = ["cli", "--logs_dir", logs, "--output_dir", str(tmp_path / "eval"),
                 "--gt_dir", info["gt_dir"], "--dsm", "--dsm_resolution", "2"]
    out = tcli.eval_cli(eval_args, device="cpu")
    printed = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out and sorted(out) == ["dsm_path", "mae", "rdsm_path"]
    assert os.path.exists(out["dsm_path"]) and os.path.exists(out["rdsm_path"])
    out2 = tcli.eval_cli([*eval_args, "--output_dir", str(tmp_path / "eval2"), "--data_axis",
                          "2"], device="cpu")
    printed = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out2 and sorted(out2) == ["dsm_path", "mae", "rdsm_path"]
    assert out2["dsm_path"].startswith(str(tmp_path / "eval2"))
    assert os.path.exists(out2["dsm_path"]) and os.path.exists(out2["rdsm_path"])
    assert abs(out2["mae"] - out["mae"]) < 1.0
    with pytest.raises(ValueError, match="rpc_correction"):
        tcli.eval_cli([*eval_args, "--export_rpc"], device="cpu")


@pytest.mark.parametrize("launcher", ["spawn", "torchrun"])
def test_data_axis_two_trains_on_the_cpu(tmp_path, launcher):
    """``python train_eonerf_torch.py --data_axis 2 --device cpu`` (the entry
    point spawns the ranks) and the same under ``torchrun --standalone
    --nproc_per_node 2`` (the ranks join the launcher's group): two gloo
    ranks train 2 steps of batch 128 (64 rays a rank); one opts.json with
    data_axis 2, one metrics.jsonl (rank 0's), one set of checkpoints, and
    rank 0's stats printed once."""
    info = tsyn.generate_scene(str(tmp_path / "scene"),
                               tsyn.SyntheticSceneSpec(n_views=2, n_test_views=1, img_size=24))
    logs = tmp_path / "logs"
    start = ([sys.executable] if launcher == "spawn" else
             [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
              "2"])
    proc = subprocess.run(
        [*start, str(REPO / "train_eonerf_torch.py"), "--root_dir", info["root_dir"],
         "--img_dir", info["img_dir"], "--logs_dir", str(logs), "--exp_name", "dp",
         "--max_train_steps", "2", "--fc_layers", "2", "--fc_units", "32", "--n_samples", "16",
         "--batch_size", "128", "--n_grid", "16", "--save_freq", "1", "--data_axis", "2",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})     # one thread a rank: tiny shapes
    assert proc.returncode == 0, proc.stderr[-4000:]
    stats = [ast.literal_eval(line) for line in proc.stdout.splitlines()
             if line.startswith("{'steps'")]
    assert len(stats) == 1 and stats[0]["steps"] == 2
    run = logs / "dp"
    assert sorted(p.name for p in run.iterdir() if not p.name.startswith("events.")) == [
        "ckpts", "metrics.jsonl", "opts.json"]
    assert TrainConfig.load(str(run / "opts.json")).data_axis == 2
    assert sorted(p.name for p in (run / "ckpts").iterdir()) == ["epoch=0", "epoch=1"]
    with open(run / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows if r["tag"] == "train/loss"] == [0]   # every 50 steps


@pytest.mark.parametrize("case", ["cards", "shared_card_nccl", "batch", "no_group"])
def test_data_axis_refusals(tmp_path, monkeypatch, case):
    """Nothing falls back. "cards": --data_axis 2 on one visible card raises
    ValueError naming both numbers before a worker starts; "shared_card_nccl":
    two ranks on one card ("cuda:0") are not refused, and take gloo, which
    NCCL's one card a rank leaves (one rank there, and ranks on cards of
    their own, NCCL; the CPU gloo); "batch": a batch that does not divide
    over the ranks raises in the Trainer; "no_group": a Trainer at
    data_axis 2 outside a process group raises."""
    from eonerf_code_tpu_torch.parallel import mesh as pmesh
    from eonerf_code_tpu_torch.train import loop as tloop

    monkeypatch.setattr(pmesh.torch.cuda, "device_count", lambda: 1)
    if case == "cards":
        with pytest.raises(ValueError, match="data_axis=2 but only 1 CUDA devices visible"):
            tcli.main_train(["--root_dir", str(tmp_path), "--data_axis", "2"], device="cuda")
        return
    if case == "shared_card_nccl":
        assert pmesh.resolve_world(2, "cuda:0") == 2
        assert [pmesh.backend_for(d, w) for d, w in [("cuda:0", 2), ("cuda:0", 1),
                                                      ("cuda", 2), ("cpu", 2)]] == [
            "gloo", "nccl", "nccl", "gloo"]
        return
    cfg = TrainConfig(logs_dir=str(tmp_path), net_depth=2, net_width=32, batch_size=63,
                      sampler="uniform", data_axis=2)
    if case == "batch":
        monkeypatch.setattr(tloop.pmesh, "current",
                            lambda data_axis, device: pmesh.Mesh({"scene": 1, "data": 2}, 0,
                                                                 torch.device(device)))
        match = "batch_size=63 does not divide over data_axis=2 ranks"
    else:
        match = "asks for 2 processes"
    with pytest.raises(ValueError, match=match):
        tloop.Trainer(cfg, {"rays": np.zeros((256, 11), np.float32),
                            "rgbs": np.zeros((256, 3), np.float32),
                            "ts": np.zeros((256,), np.int32)}, n_images=1, device="cpu")
