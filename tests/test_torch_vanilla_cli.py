"""The port's vanilla-NeRF entry point, train_mlp_nerf_torch.py, on the
JAX vanilla pin's scene and flags (tests/test_blender.py:100-114) on the
CPU: it must report a test PSNR over the pin's 18 dB and write the JAX
trainer's logger tags; the scene that eonerf_code_tpu_torch/e2e.py writes
with io/png.py is the pin's own; and the entry points refuse the card
where there is none. Training parity is test_torch_vanilla.py's."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image
from test_blender import make_mini_blender
from torch_fixtures import one_thread  # noqa: F401

import train_mlp_nerf_torch
from eonerf_code_tpu_torch import e2e
from eonerf_code_tpu_torch.io.png import read_png
from eonerf_code_tpu_torch.train import train_vanilla as tv

# the JAX pin's gate (tests/test_blender.py:114)
PSNR_GATE_DB = 18.0
PIN_FLAGS = ["--train_split", "train", "--max_steps", "300", "--batch_size", "256",
             "--net_depth", "2", "--net_width", "32", "--n_samples", "17",
             "--grid_resolution", "16", "--n_test_images", "1", "--test_chunk_size", "512"]


def test_scene_is_the_pins(tmp_path):
    """e2e.blender_scene at the pin's defaults: the pin's poses and, pixel
    for pixel, its PIL-written frames."""
    root, subject = e2e.blender_scene(str(tmp_path / "port"))
    pin_root, pin_subject = make_mini_blender(str(tmp_path / "pin"))
    assert subject == pin_subject
    for split in ("train", "val", "test"):
        name = f"transforms_{split}.json"
        with open(os.path.join(root, subject, name)) as a, \
                open(os.path.join(pin_root, subject, name)) as b:
            assert json.load(a) == json.load(b)
    for i in range(3):
        np.testing.assert_array_equal(
            read_png(os.path.join(root, subject, f"r_{i}.png")),
            np.asarray(Image.open(os.path.join(pin_root, subject, f"r_{i}.png"))))


def test_cli_reaches_the_pins_psnr(tmp_path, capsys, one_thread):
    root, subject = e2e.blender_scene(str(tmp_path / "data"))
    logs = tmp_path / "logs"
    psnr = train_mlp_nerf_torch.main(["--data_root", root, "--scene", subject, "--logs_dir",
                                      str(logs), *PIN_FLAGS, "--device", "cpu"])
    assert psnr > PSNR_GATE_DB
    assert f"test PSNR: {psnr:.2f} dB" in capsys.readouterr().out
    with open(logs / f"vanilla_{subject}" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    tags = {r["tag"] for r in rows}
    assert tags == {"train/loss", "train/n_eff_samples", "perf/rays_per_sec"}
    # log_every 100: steps 0, 100, 200
    assert sorted(r["step"] for r in rows if r["tag"] == "train/loss") == [0, 100, 200]
    assert all(np.isfinite(r["value"]) for r in rows)


def test_entry_points_refuse_the_card_without_one(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, subject = e2e.blender_scene(str(tmp_path / "data"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv.train_vanilla(subject_id=subject, root_fp=root, logs_dir=str(tmp_path), max_steps=1,
                         device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mlp_nerf_torch.main(["--data_root", root, "--scene", subject, "--logs_dir",
                                   str(tmp_path), "--max_steps", "1"])
    assert not os.path.exists(tmp_path / f"vanilla_{subject}")


def test_train_vanilla_returns_the_jax_keys(tmp_path, one_thread):
    root, subject = e2e.blender_scene(str(tmp_path / "data"))
    res = tv.train_vanilla(subject_id=subject, root_fp=root, logs_dir=str(tmp_path),
                           max_steps=3, batch_size=32, n_samples=9, grid_resolution=8,
                           occ_every=2, net_depth=2, net_width=16, device="cpu")
    assert sorted(res) == ["dataset", "elapsed_s", "grid", "model", "params", "rcfg"]
    assert res["params"].keys() == res["model"].state_dict().keys()
    assert all(torch.isfinite(v).all() for v in res["params"].values())
    assert res["grid"].resolution == 8 and res["grid"].aabb_max == 1.5
    # updated at steps 0 and 2: no longer the all-open start
    assert float(res["grid"].occs.abs().sum()) > 0
