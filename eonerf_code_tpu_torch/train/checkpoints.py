"""Checkpoints: ``torch.save`` of the trainer's state dict (params,
opt_state, step, epoch, rng, and the occupancy grid and gate history) into
``<log_dir>/ckpts/epoch=<tag>/state.pt`` (the JAX package's directory
names), with optional JSON sidecars beside it (``occ_sampling.json``).
Integer tags are idempotent: an existing one is never overwritten, its
sidecars included, so a resumed run cannot destroy the checkpoint it
started from (the JAX package rewrites the sidecar of a kept integer tag).
Named tags ("best") are overwritten. Writes go to a temporary file first
and are renamed into place."""

import json
import os

import torch

STATE_FILE = "state.pt"


def _ckpt_dir(log_dir, epoch):
    return os.path.abspath(os.path.join(log_dir, "ckpts", f"epoch={epoch}"))


def _write_atomic(path, write):
    tmp = f"{path}.{os.getpid()}.tmp"
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(log_dir, epoch, state, overwrite=None, sidecars=None):
    """Save ``state`` (and ``sidecars``, {file name: JSON-able object})
    under ``epoch=<epoch>``; returns the directory."""
    path = _ckpt_dir(log_dir, epoch)
    if overwrite is None:
        overwrite = not isinstance(epoch, int)
    if not overwrite and os.path.isdir(path):
        return path
    os.makedirs(path, exist_ok=True)
    _write_atomic(os.path.join(path, STATE_FILE), lambda tmp: torch.save(state, tmp))
    for name, obj in (sidecars or {}).items():
        def dump(tmp, obj=obj):
            with open(tmp, "w") as f:
                json.dump(obj, f)
        _write_atomic(os.path.join(path, name), dump)
    return path


def latest_checkpoint(log_dir):
    d = os.path.join(log_dir, "ckpts")
    if not os.path.isdir(d):
        return None
    epochs = []
    for name in os.listdir(d):
        if name.startswith("epoch="):
            try:
                epochs.append(int(name.split("=")[1]))
            except ValueError:
                pass
    if not epochs:
        return None
    return _ckpt_dir(log_dir, max(epochs))


def restore_checkpoint(path, map_location=None):
    return torch.load(os.path.join(path, STATE_FILE), map_location=map_location,
                      weights_only=True)
