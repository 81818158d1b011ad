"""The bridge from the JAX package's state to the port's: the flax
parameter tree to and from a module's ``state_dict()`` (``EONerfField``,
``VanillaNeRF``, ``DNeRF``), the multi-AOI
trainer's scene-stacked trees to and from per-scene state dicts, and an
occupancy grid's arrays to an ``OccupancyGrid``.

The flax tree is given as nested dicts of numpy arrays,
``{"params": {scope: {layer: {"kernel", "bias"}} | {"embedding"}}}``, the
scopes nested as deep as the modules are. Module scopes and layer names are the same on both sides; a flax ``Dense``
kernel is (in, out) and an ``nn.Linear`` weight is (out, in), so matrices
are transposed; a flax ``Embed`` table is an ``nn.Embedding`` weight as is.
"""

import numpy as np
import torch

from eonerf_code_tpu_torch.ops.occupancy import OccupancyGrid


def field_state_from_jax(params_np):
    """A flax module's params (numpy) -> the port's state_dict (float32 CPU
    tensors; ``load_state_dict`` moves them to the module's device). Scopes
    nest to any depth (``nerf.trunk.hidden_0`` in DNeRF); a scope holding a
    ``kernel`` is a Dense, one holding an ``embedding`` an Embed."""
    state = {}

    def walk(prefix, sub):
        if "embedding" in sub:
            state[f"{prefix}weight"] = torch.from_numpy(np.array(sub["embedding"], np.float32))
        elif "kernel" in sub:
            state[f"{prefix}weight"] = torch.from_numpy(
                np.array(sub["kernel"], np.float32).T.copy())
            state[f"{prefix}bias"] = torch.from_numpy(np.array(sub["bias"], np.float32))
        else:
            for name, child in sub.items():
                walk(f"{prefix}{name}.", child)

    walk("", params_np["params"])
    return state


def jax_params_from_field_state(state):
    """Inverse of :func:`field_state_from_jax`: state_dict -> flax tree of
    float32 numpy arrays. A module with a bias is a Dense (its weight
    transposed into ``kernel``), one with a weight alone an Embed."""
    tree = {}
    for name, t in state.items():
        a = t.detach().to("cpu", torch.float32).numpy()
        *scopes, kind = name.split(".")
        entry = tree
        for scope in scopes:
            entry = entry.setdefault(scope, {})
        if kind == "bias":
            entry["bias"] = a.copy()
        elif f"{'.'.join(scopes)}.bias" in state:
            entry["kernel"] = a.T.copy()
        else:
            entry["embedding"] = a.copy()
    return {"params": tree}


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def pod_states_from_jax(stacked_params_np):
    """The JAX ``MultiAOITrainer``'s scene-stacked flax params (numpy
    leaves with a leading scene axis) -> one port state_dict a scene."""
    n = np.shape(_leaves(stacked_params_np)[0])[0]
    return [field_state_from_jax(_map_tree(lambda x, i=i: np.asarray(x)[i], stacked_params_np))
            for i in range(n)]


def pod_states_to_jax(states):
    """Inverse of :func:`pod_states_from_jax`: per-scene state dicts -> the
    scene-stacked flax tree of float32 numpy arrays."""
    trees = [jax_params_from_field_state(s) for s in states]

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack(xs)

    return stack(*trees)


def _stack_states(states):
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


def pod_adam_from_jax(count, mu, nu):
    """The JAX ``MultiAOITrainer``'s Adam state (numpy: ``count`` (S,), the
    moments ``mu`` and ``nu`` as scene-stacked flax trees) -> the port's pod
    ``opt_state`` ({"count" (S,) float32, "mu", "nu": {name: (S, ...)}})."""
    return {"count": torch.from_numpy(np.asarray(count, np.float32).copy()),
            "mu": _stack_states(pod_states_from_jax(mu)),
            "nu": _stack_states(pod_states_from_jax(nu))}


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
