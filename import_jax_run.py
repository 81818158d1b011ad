#!/usr/bin/env python
"""Turn a run directory of the JAX package into one the PyTorch port reads.

    python import_jax_run.py <jax_run_dir> <port_run_dir>
    python import_jax_run.py --pod <jax_exp_dir> <port_exp_dir>

- ``opts.json`` is copied as it is: the port's ``TrainConfig.load`` drops
  the keys it does not have, and they are printed here.
- Each ``ckpts/epoch=<tag>`` (an orbax checkpoint) becomes
  ``ckpts/epoch=<tag>/state.pt`` with the field's parameters, the
  occupancy grid, ``step``, ``epoch`` and the tightening gate (its history
  rings decoded to lists, and its verdict ``tighten_active``), beside a
  copy of its ``occ_sampling.json``. No optimizer state is carried: an
  imported checkpoint evaluates, and the port's trainer refuses to resume
  from it.

``--pod`` takes a multi-AOI experiment (train_multi_aoi.py's
``<logs>/<exp>``): each ``_pod/ckpts/epoch=<step>`` becomes the port's pod
checkpoint (every scene's parameters, Adam's count and moments, the step,
the occupancy grids, the gate ring decoded to a tensor) beside a copy of its
``pod_occ_sampling.json`` (or of its older ``occ_sampling.json``), which
``train_multi_aoi_torch.py --resume`` continues with the same flags; each
scene's run directory (``<exp>/<aoi>``) is imported as above.

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
    state = {"params": field_state_from_jax(restored["params"]), "step": int(restored["step"])}
    if "epoch" in restored:       # a multi-AOI scene's checkpoint has none
        state["epoch"] = int(restored["epoch"])
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


def convert_pod_checkpoint(src, port_pod_dir, tag):
    """One orbax pod checkpoint of the JAX MultiAOITrainer ->
    ``port_pod_dir/ckpts/epoch=<tag>``."""
    import orbax.checkpoint as ocp
    import torch

    from eonerf_code_tpu_torch.interop.jax_params import pod_adam_from_jax, pod_states_from_jax
    from eonerf_code_tpu_torch.parallel.multi_aoi import POD_SIDECAR, stack_params
    from eonerf_code_tpu_torch.train import checkpoints as ckpt_lib

    restored = _numpy_tree(_lists_as_dicts(
        ocp.PyTreeCheckpointer().restore(os.path.abspath(src))))
    adam = restored["opt_state"]["0"]     # optax.adam: (scale_by_adam, scale_by_schedule)
    state = {"params": stack_params(pod_states_from_jax(restored["params"])),
             "opt_state": pod_adam_from_jax(adam["count"], adam["mu"], adam["nu"]),
             "step": int(restored["step"])}
    if "gate" in restored:
        gate = restored["gate"]
        state["gate"] = {"frac_hist": torch.from_numpy(np.array(gate["frac_hist"], np.float32)),
                         "n_frac": int(gate["n_frac"]),
                         "tighten_active": int(gate["tighten_active"])}
    if "occ" in restored:
        state["occ"] = {"occs": torch.from_numpy(np.array(restored["occ"]["occs"], np.float32)),
                        "binaries": torch.from_numpy(np.array(restored["occ"]["binaries"],
                                                              bool))}
    sidecars = {}
    for name in (POD_SIDECAR, "occ_sampling.json"):
        if os.path.exists(os.path.join(src, name)):
            with open(os.path.join(src, name)) as f:
                sidecars[name] = json.load(f)
            break
    return ckpt_lib.save_checkpoint(port_pod_dir, tag, state, overwrite=True, sidecars=sidecars)


def _lists_as_dicts(tree):
    """Sequences in a restored tree as dicts keyed "0", "1", ..."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: _lists_as_dicts(v) for k, v in tree.items()}
    return tree


def _tags(ckpt_root):
    return sorted(name.split("=", 1)[1] for name in os.listdir(ckpt_root)
                  if name.startswith("epoch=")) if os.path.isdir(ckpt_root) else []


def import_run(jax_run_dir, port_run_dir):
    """opts.json and every checkpoint of one run; returns the tags."""
    from eonerf_code_tpu_torch.config import TrainConfig

    opts = os.path.join(jax_run_dir, "opts.json")
    if not os.path.exists(opts):
        raise SystemExit(f"error: no training run at '{jax_run_dir}' (missing {opts})")
    os.makedirs(port_run_dir, exist_ok=True)
    shutil.copyfile(opts, os.path.join(port_run_dir, "opts.json"))
    with open(opts) as f:
        jax_opts = json.load(f)
    dropped = sorted(set(jax_opts) - {f.name for f in dataclasses.fields(TrainConfig)})
    print(f"opts.json keys the port does not read: {dropped}")
    ckpt_root = os.path.join(jax_run_dir, "ckpts")
    tags = _tags(ckpt_root)
    for tag in tags:
        path = convert_checkpoint(os.path.join(ckpt_root, f"epoch={tag}"), port_run_dir, tag)
        print(f"epoch={tag} -> {path}")
    return tags


def import_pod(jax_exp_dir, port_exp_dir):
    """Every pod checkpoint of a multi-AOI experiment and every scene's run
    directory; returns {"_pod": pod tags, <aoi>: run tags}."""
    pod_root = os.path.join(jax_exp_dir, "_pod", "ckpts")
    if not os.path.isdir(pod_root):
        raise SystemExit(f"error: no pod checkpoints at '{pod_root}'")
    out = {"_pod": _tags(pod_root)}
    for tag in out["_pod"]:
        path = convert_pod_checkpoint(os.path.join(pod_root, f"epoch={tag}"),
                                      os.path.join(port_exp_dir, "_pod"), tag)
        print(f"_pod epoch={tag} -> {path}")
    for name in sorted(os.listdir(jax_exp_dir)):
        if name != "_pod" and os.path.exists(os.path.join(jax_exp_dir, name, "opts.json")):
            out[name] = import_run(os.path.join(jax_exp_dir, name),
                                   os.path.join(port_exp_dir, name))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pod", action="store_true",
                   help="a multi-AOI experiment directory: its pod checkpoints and scene runs")
    p.add_argument("jax_run_dir")
    p.add_argument("port_run_dir")
    args = p.parse_args(argv)
    if args.pod:
        return import_pod(args.jax_run_dir, args.port_run_dir)
    return import_run(args.jax_run_dir, args.port_run_dir)


if __name__ == "__main__":
    main()
