"""Checkpoints: ``torch.save`` of ``{params, opt_state, step, epoch, rng}``
into ``<log_dir>/ckpts/epoch=<tag>/state.pt`` (the JAX package's directory
names). Integer tags are idempotent: an existing one is never overwritten,
so a resumed run cannot destroy the checkpoint it started from. Named tags
("best") are overwritten. Writes go to a temporary file first and are
renamed into place."""

import os

import torch

STATE_FILE = "state.pt"


def _ckpt_dir(log_dir, epoch):
    return os.path.abspath(os.path.join(log_dir, "ckpts", f"epoch={epoch}"))


def save_checkpoint(log_dir, epoch, state, overwrite=None):
    path = _ckpt_dir(log_dir, epoch)
    if overwrite is None:
        overwrite = not isinstance(epoch, int)
    if not overwrite and os.path.isdir(path):
        return path
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"{STATE_FILE}.{os.getpid()}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
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
