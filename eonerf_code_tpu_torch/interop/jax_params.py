"""The bridge from the JAX package's state to the port's: the flax
parameter tree to and from ``EONerfField.state_dict()``, and an occupancy
grid's arrays to an ``OccupancyGrid``.

The flax tree is given as nested dicts of numpy arrays,
``{"params": {scope: {layer: {"kernel", "bias"}} | {"embedding"}}}``.
Module scopes and layer names are the same on both sides; a flax ``Dense``
kernel is (in, out) and an ``nn.Linear`` weight is (out, in), so matrices
are transposed; a flax ``Embed`` table is an ``nn.Embedding`` weight as is.
"""

import numpy as np
import torch

from eonerf_code_tpu_torch.ops.occupancy import OccupancyGrid


def field_state_from_jax(params_np):
    """flax EONerfField params (numpy) -> the port's state_dict (float32
    CPU tensors; ``load_state_dict`` moves them to the field's device)."""
    state = {}
    for scope, sub in params_np["params"].items():
        if "embedding" in sub:
            state[f"{scope}.weight"] = torch.from_numpy(
                np.array(sub["embedding"], np.float32))
            continue
        for layer, p in sub.items():
            state[f"{scope}.{layer}.weight"] = torch.from_numpy(
                np.array(p["kernel"], np.float32).T.copy())
            state[f"{scope}.{layer}.bias"] = torch.from_numpy(
                np.array(p["bias"], np.float32))
    return state


def jax_params_from_field_state(state):
    """Inverse of :func:`field_state_from_jax`: state_dict -> flax tree of
    float32 numpy arrays."""
    tree = {}
    for name, t in state.items():
        a = t.detach().to("cpu", torch.float32).numpy()
        parts = name.split(".")
        if len(parts) == 2:          # "<scope>.weight" of an nn.Embedding
            tree.setdefault(parts[0], {})["embedding"] = a.copy()
            continue
        scope, layer, kind = parts
        entry = tree.setdefault(scope, {}).setdefault(layer, {})
        if kind == "weight":
            entry["kernel"] = a.T.copy()
        else:
            entry["bias"] = a.copy()
    return {"params": tree}


def occ_grid_from_jax(occs, binaries, device="cpu"):
    """The JAX package's ``OccupancyGrid`` arrays (numpy: ``occs``
    (res^3,) float32, ``binaries`` (res, res, res) bool) -> the port's
    grid on ``device``."""
    binaries = np.asarray(binaries, dtype=bool)
    res = binaries.shape[0]
    if binaries.shape != (res,) * 3 or np.shape(occs) != (res ** 3,):
        raise ValueError(f"occupancy arrays of shapes {np.shape(occs)}, {binaries.shape} are "
                         "not a cubic grid")
    return OccupancyGrid(occs=torch.from_numpy(np.array(occs, np.float32)).to(device),
                         binaries=torch.from_numpy(binaries.copy()).to(device), resolution=res)
