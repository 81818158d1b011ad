#!/usr/bin/env python
"""Turn a run directory of the JAX package into one the PyTorch port reads.

    python import_jax_run.py <jax_run_dir> <port_run_dir>

- ``opts.json`` is copied as it is: the port's ``TrainConfig.load`` drops
  the keys it does not have, and they are printed here.
- Each ``ckpts/epoch=<tag>`` (an orbax checkpoint) becomes
  ``ckpts/epoch=<tag>/state.pt`` with the field's parameters, the
  occupancy grid, ``step``, ``epoch`` and the tightening gate (its history
  rings decoded to lists, and its verdict ``tighten_active``), beside a
  copy of its ``occ_sampling.json``. No optimizer state is carried: an
  imported checkpoint evaluates, and the port's trainer refuses to resume
  from it.

It reads orbax checkpoints, so it runs where JAX and orbax are installed;
copy the port's run directory to the card afterwards. The port itself
never imports this script.
"""

import argparse
import dataclasses
import json
import os
import shutil

import numpy as np


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _ring_to_list(ring):
    """The JAX trainer's gate ring (NaN-padded float32) -> its history list."""
    a = np.asarray(ring, dtype=np.float32)
    return [float(x) for x in a[~np.isnan(a)]]


def convert_checkpoint(src, port_run_dir, tag):
    """One orbax checkpoint directory -> ``port_run_dir/ckpts/epoch=<tag>``."""
    import orbax.checkpoint as ocp

    from eonerf_code_tpu_torch.interop.jax_params import field_state_from_jax, occ_grid_from_jax
    from eonerf_code_tpu_torch.train import checkpoints as ckpt_lib
    from eonerf_code_tpu_torch.train.loop import OCC_SIDECAR

    restored = _numpy_tree(ocp.PyTreeCheckpointer().restore(os.path.abspath(src)))
    state = {"params": field_state_from_jax(restored["params"]),
             "step": int(restored["step"]), "epoch": int(restored["epoch"])}
    if "occ" in restored:
        grid = occ_grid_from_jax(restored["occ"]["occs"], restored["occ"]["binaries"])
        state["occ"] = {"occs": grid.occs, "binaries": grid.binaries}
    if "gate" in restored:
        gate = restored["gate"]
        state["gate"] = {"frac_hist": _ring_to_list(gate["frac_hist"]),
                         "entropy_hist": _ring_to_list(gate["entropy_hist"]),
                         "tighten_active": bool(int(gate["tighten_active"]))}
    sidecars = {}
    if os.path.exists(os.path.join(src, OCC_SIDECAR)):
        with open(os.path.join(src, OCC_SIDECAR)) as f:
            sidecars[OCC_SIDECAR] = json.load(f)
    return ckpt_lib.save_checkpoint(port_run_dir, tag, state, overwrite=True, sidecars=sidecars)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("jax_run_dir")
    p.add_argument("port_run_dir")
    args = p.parse_args(argv)

    from eonerf_code_tpu_torch.config import TrainConfig

    opts = os.path.join(args.jax_run_dir, "opts.json")
    if not os.path.exists(opts):
        raise SystemExit(f"error: no training run at '{args.jax_run_dir}' (missing {opts})")
    os.makedirs(args.port_run_dir, exist_ok=True)
    shutil.copyfile(opts, os.path.join(args.port_run_dir, "opts.json"))
    with open(opts) as f:
        jax_opts = json.load(f)
    dropped = sorted(set(jax_opts) - {f.name for f in dataclasses.fields(TrainConfig)})
    print(f"opts.json keys the port does not read: {dropped}")
    ckpt_root = os.path.join(args.jax_run_dir, "ckpts")
    tags = sorted(name.split("=", 1)[1] for name in os.listdir(ckpt_root)
                  if name.startswith("epoch=")) if os.path.isdir(ckpt_root) else []
    for tag in tags:
        path = convert_checkpoint(os.path.join(ckpt_root, f"epoch={tag}"), args.port_run_dir, tag)
        print(f"epoch={tag} -> {path}")
    return tags


if __name__ == "__main__":
    main()
