"""The port's command-line interface against the JAX package's cli.py: the
same flag names and ``dest``s in the training and eval parsers, the same
TrainConfig from the same arguments, the flags the port refuses or
ignores (``--data_axis``, ``--steps_per_call``) and those it now takes
(``--use_pallas``, ``--freq_reg_*``), and the two entry points end to end on the CPU: 2
training steps of a 2 x 32 field on a generated scene (2 train views, 1
test view, 24 x 24; GT at 2 m), then its DSM eval."""

import argparse
import ast
import dataclasses
import json
import os

import pytest

from eonerf_code_tpu import cli as jcli
from eonerf_code_tpu.eval import run as jrun
from eonerf_code_tpu_torch import cli as tcli
from eonerf_code_tpu_torch.config import TrainConfig
from eonerf_code_tpu_torch.data import synthetic as tsyn

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
    (["--data_axis", "2"], NotImplementedError, "item 6"),
    (["--data_axis", "-1"], NotImplementedError, "item 6"),
    (["--freq_reg_start_step", "5"], ValueError, "END step")])
def test_refused_flags_raise(extra, error, match):
    """--data_axis past 1 and an annealing start without its end raise.
    --use_pallas, refused until the use_pallas slice, now sets
    TrainConfig.use_pallas (``match``: the field and its value)."""
    if error is None:
        name, value = match
        assert getattr(tcli.config_from_args(["--root_dir", "/r", *extra]), name) is value
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
    that run prints the JAX eval's dict (mae, dsm_path, rdsm_path);
    --data_axis 2 and --export_rpc on a run without offsets raise."""
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
    with pytest.raises(NotImplementedError, match="item 6"):
        tcli.eval_cli([*eval_args, "--data_axis", "2"], device="cpu")
    with pytest.raises(ValueError, match="rpc_correction"):
        tcli.eval_cli([*eval_args, "--export_rpc"], device="cpu")
