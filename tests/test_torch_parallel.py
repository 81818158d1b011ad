"""Data parallel on the CPU. One group of two ranks (gloo, spawned by
``parallel.mesh.launch`` with a ``file://`` rendezvous; the kernels' plain
versions) runs every world-2 check, held against the port at world 1 and
against the JAX package on a 2-device mesh of the 8 virtual CPU devices:

(i) two steps of ``make_train_step`` on the 8x256 kernel-backed field, one
    global batch a step with depth, confidence and shadow priors whose
    valid counts differ between the two shards, against world 1;
(ii) the same steps against the JAX ``make_train_step`` with its batch
    sharded over ``make_mesh(n_data=2)``;
(iii) an 8-step ``Trainer`` run on a generated scene, jitter on, against
    world 1, the ranks' parameters equal at the end;
(iv) occupancy tightening with the entropy gate: the grids and the gate
    histories equal on both ranks after three updates;
(v) ``render_image_sharded`` at a ragged ray count against ``render_image``
    with and without jitter, and the JAX ``render_image_sharded``;
(vi) rank 0 alone writes opts.json, the metrics, the checkpoints and their
    sidecars, and validates.

The worker functions import no JAX (the spawned ranks import this module);
the JAX side runs here, in the test process."""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

from eonerf_code_tpu_torch.config import TrainConfig
from eonerf_code_tpu_torch.data.rays import SatRays
from eonerf_code_tpu_torch.data.synthetic_pool import synthetic_ray_pool
from eonerf_code_tpu_torch.models.eonerf import EONerfField
from eonerf_code_tpu_torch.models.fused import KernelField
from eonerf_code_tpu_torch.parallel import mesh as pmesh
from eonerf_code_tpu_torch.render import satellite as tsat
from eonerf_code_tpu_torch.train import checkpoints as ckpt_lib
from eonerf_code_tpu_torch.train import loop as tloop

WORLD = 2
# (shadows, use_beta) of the two steps, and each step's global batch (the
# scene's rays 0-2 carry an invalid depth prior, so the shards' counts differ)
STEPS = [(False, False), (True, True)]
STEP_IDX = [np.arange(16), np.arange(8, 24)]
RCFG = dict(n_samples=16, sc_n_samples=16, perturb=False)
FLAGS = dict(has_depth=True, has_conf=True, has_shadow=True)
# world 2 against world 1 on one global batch: the same arithmetic, but the
# gradient summed over 8 + 8 rays in place of 16. In float64 that is exact
# to far below the pins (1e-6: losses, gradients, parameters after two Adam
# steps). In float32 the sums round in another order: the gradient moves by
# 4.5e-6 rel-L2 (measured on the CPU), and Adam turns a rounding-level
# change of a gradient component near its eps (1e-8) into a change of up to
# lr: the parameters after two steps lie 3.2e-6 apart (measured), so float32
# holds the gradient and the parameters at 1e-5 (test_torch_train.py pins
# the JAX comparison's displacement at 1e-3 for the same reason)
DP_REL = 1e-6
DP_F32_REL = 1e-5
# the JAX package's weak-scaling pin (tests/test_trainer_mesh.py)
TRAJ_RTOL, TRAJ_ATOL = 2e-3, 1e-5
N_RENDER, RENDER_CHUNK = 500, 64
DEPTH_TOL = 1e-5


def _rel(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _flat(state):
    return np.concatenate([state[k].detach().cpu().double().numpy().ravel()
                           for k in sorted(state)])


# ---- what each rank runs (and world 1 in this process) ----

def _steps(inputs, mesh, device, dtype="float32"):
    """Two make_train_step steps on this rank's rows, of the kernel-backed
    8x256 field (float32) or of the field itself in float64: the loss
    dicts, the first step's (all-reduced) gradients and the parameters
    after."""
    dt = getattr(torch, dtype)
    field = EONerfField(4, compute_dtype=dt, device=device)
    field.load_state_dict(inputs["step_state"])
    field = field.to(dt)
    cfg = TrainConfig(lr=5e-4, lr_decay_steps=2, batch_size=16)
    opt = tloop.make_optimizer(field.parameters(), cfg)
    step = tloop.make_train_step(KernelField(field) if dtype == "float32" else field, opt,
                                 tloop.make_lr_schedule(cfg, 1), tsat.RenderConfig(**RCFG),
                                 **FLAGS, mesh=mesh)
    mesh = pmesh.Mesh.single() if mesh is None else mesh
    losses, grads = [], None
    for i, ((shadows, use_beta), idx) in enumerate(zip(STEPS, STEP_IDX)):
        global_batch = {k: torch.as_tensor(v[idx]) for k, v in inputs["step_data"].items()}
        global_batch = {k: v.long() if k == "ts" else v.to(dt) for k, v in global_batch.items()}
        batch = {k: pmesh.shard_rows(v, mesh.rank, mesh.world) for k, v in global_batch.items()}
        ld = step(batch, i, 100.0, shadows, use_beta, global_batch=global_batch)
        losses.append({k: float(v) for k, v in ld.items()})
        if i == 0:
            grads = {n: p.grad.clone() for n, p in field.named_parameters()}
    return {"losses": losses, "grads": grads, "state": field.state_dict()}


def _trainer_cfg(inputs, logs, data_axis):
    scene = inputs["scene"]
    return TrainConfig(root_dir=scene["root_dir"], img_dir=scene["img_dir"], logs_dir=logs,
                       exp_name="dp", net_depth=2, net_width=32, batch_size=64, n_samples=16,
                       sampler="uniform", occ_enabled=False, first_shadow_step=2,
                       first_beta_step=4, max_train_steps=8, val_freq=4, save_freq=4,
                       n_val_images=2, seed=5, data_axis=data_axis)


def _trainer(inputs, logs, data_axis, device):
    """(iii) and (vi): 8 steps on the generated scene with validation and
    checkpoints every 4; the parameters after, and how often this rank
    wrote opts.json, saved a checkpoint and validated."""
    calls = {"opts": 0, "save_checkpoint": 0, "validate": 0}

    def counted(owner, name, key):
        orig = getattr(owner, name)

        def wrapper(*args, **kwargs):
            calls[key] += 1
            return orig(*args, **kwargs)

        setattr(owner, name, wrapper)
        return orig

    patched = [(TrainConfig, "save", counted(TrainConfig, "save", "opts")),
               (ckpt_lib, "save_checkpoint",
                counted(ckpt_lib, "save_checkpoint", "save_checkpoint")),
               (tloop.Trainer, "validate", counted(tloop.Trainer, "validate", "validate"))]
    try:
        tr = tloop.Trainer(_trainer_cfg(inputs, logs, data_axis), device=device)
        tr.run(log_every=1)
    finally:
        for owner, name, orig in patched:
            setattr(owner, name, orig)
    return {"state": tr.field.state_dict(), "calls": calls,
            "logger": type(tr.logger).__name__}


def _occupancy(mesh, logs, device):
    """(iv): three grid updates with tightening and the entropy gate."""
    cfg = TrainConfig(logs_dir=logs, exp_name="occ", net_depth=2, net_width=32, batch_size=64,
                      n_samples=16, occ_tighten=True, n_grid=16, occ_update_every=1,
                      occ_max_cells=512, occ_tighten_start_step=0, occ_entropy_max=10.0,
                      max_train_steps=3, save_freq=10 ** 9, seed=2, data_axis=mesh.world)
    tr = tloop.Trainer(cfg, synthetic_ray_pool(2048, 4, device), n_images=4, device=device)
    tr.run(log_every=10 ** 9)
    return {"occs": tr.occ_grid.occs, "binaries": tr.occ_grid.binaries,
            "frac_hist": tr._occ_frac_hist, "entropy_hist": tr._entropy_hist}


def _render_field(inputs, device):
    field = EONerfField(3, net_depth=2, net_width=32, device=device)
    field.load_state_dict(inputs["render_state"])
    return field


def _render_rays(inputs):
    r = inputs["rays"]
    return SatRays(*(torch.as_tensor(r[k]) for k in ("o", "d", "sun", "ts", "near", "far")))


def _render(inputs, mesh, device):
    """(v): the sharded render without jitter, and with it (the generator
    seeded 1)."""
    field, rays = _render_field(inputs, device), _render_rays(inputs)
    cfg = tsat.RenderConfig(n_samples=8, sc_n_samples=8, perturb=False)
    out = tsat.render_image_sharded(field, rays, cfg, True, mesh, chunk=RENDER_CHUNK,
                                    generator=torch.Generator().manual_seed(0))
    out_p = tsat.render_image_sharded(field, rays, dataclasses.replace(cfg, perturb=True), True,
                                      mesh, chunk=RENDER_CHUNK,
                                      generator=torch.Generator().manual_seed(1))
    return {"plain": out, "perturbed": out_p}


def _on_each_rank(device, inputs, out_dir):
    mesh = pmesh.current(WORLD, device)
    return {"rank": mesh.rank,
            "steps": {dt: _steps(inputs, mesh, device, dt) for dt in ("float32", "float64")},
            "trainer": _trainer(inputs, os.path.join(out_dir, "w2"), WORLD, device),
            "occ": _occupancy(mesh, out_dir, device), "render": _render(inputs, mesh, device)}


def eval_without_jitter(device, calls):
    """``eval_eonerf(**kwargs)`` on this rank for each of ``calls`` with
    unperturbed renders, as the eval tests patch ``eval.run.RenderConfig``
    in their own process (the ranks import their modules afresh)."""
    from eonerf_code_tpu_torch.eval import run as trun

    trun.RenderConfig = functools.partial(tsat.RenderConfig, perturb=False)
    return [trun.eval_eonerf(device=device, **kwargs) for kwargs in calls]


# ---- the group, and the references in this process ----

def _jax_inputs():
    import jax
    import jax.numpy as jnp

    from eonerf_code_tpu.models.eonerf import EONerfField as JaxField
    from eonerf_code_tpu_torch.interop.jax_params import field_state_from_jax
    from test_torch_train import SCENE_SEED, _make_scene

    jf, params, data = _make_scene(SCENE_SEED, rpc_correction=False)
    np_tree = jax.tree_util.tree_map(np.asarray, params)
    rfield = JaxField(n_images=3, net_depth=2, net_width=32)
    rparams = rfield.init(jax.random.PRNGKey(0), jnp.zeros((2, 3, 3)), jnp.zeros((2, 3)),
                          jnp.zeros((2,), jnp.int32), method="init_all")
    rng = np.random.default_rng(0)
    n = N_RENDER
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = rng.uniform(-0.8, 0.8, (n, 2))
    o[:, 2] = 0.99
    d = np.tile(np.array([0.03, 0.01, -1.0], np.float32), (n, 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sun = np.tile(np.array([0.25, 0.2, -0.95], np.float32), (n, 1))
    sun /= np.linalg.norm(sun, axis=1, keepdims=True)
    rays = {"o": o, "d": d, "sun": sun, "ts": rng.integers(0, 3, n).astype(np.int64),
            "near": np.zeros((n,), np.float32), "far": 2.0 * np.ones((n,), np.float32)}
    inputs = {"step_state": field_state_from_jax(np_tree), "step_data": data,
              "render_state": field_state_from_jax(jax.tree_util.tree_map(np.asarray, rparams)),
              "rays": rays}
    return inputs, (jf, params, rfield, rparams)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every rank's results, the inputs, the JAX objects and a temp dir."""
    from eonerf_code_tpu_torch.data import synthetic as tsyn

    tmp = tmp_path_factory.mktemp("dp")
    inputs, jax_side = _jax_inputs()
    inputs["scene"] = tsyn.generate_scene(
        str(tmp / "scene"), tsyn.SyntheticSceneSpec(n_views=2, n_test_views=1, img_size=16))
    threads = torch.get_num_threads()
    torch.set_num_threads(WORLD)    # one thread a rank: tiny shapes, and other tests share the cores
    try:
        ranks = pmesh.launch(_on_each_rank, {"inputs": inputs, "out_dir": str(tmp)}, WORLD, "cpu")
    finally:
        torch.set_num_threads(threads)
    assert sorted(ranks) == [0, 1] and [ranks[r]["rank"] for r in (0, 1)] == [0, 1]
    return ranks, inputs, jax_side, tmp


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_step_matches_world_one(group, dtype):
    """(i) The shards' valid counts differ (an average of per-rank means
    would be off); the world-2 loss dicts, gradients and parameters are
    world 1's (float32: the kernel-backed field, the trainer's path;
    float64: the field itself, away from float32 rounding)."""
    ranks, inputs, _, _ = group
    data = inputs["step_data"]
    valid = (data["depth_prior"] >= 0) & (data["conf_prior"] >= 4)
    shadow = data["shadow_prior"] <= 0.5
    for idx in STEP_IDX:
        halves = [pmesh.shard_rows(idx, r, WORLD) for r in range(WORLD)]
        assert valid[halves[0]].sum() != valid[halves[1]].sum()
    assert any(shadow[pmesh.shard_rows(idx, 0, WORLD)].sum()
               != shadow[pmesh.shard_rows(idx, 1, WORLD)].sum() for idx in STEP_IDX)
    one = _steps(inputs, None, "cpu", dtype)
    tol = DP_REL if dtype == "float64" else DP_F32_REL
    for r in range(WORLD):
        two = ranks[r]["steps"][dtype]
        for i, (a, b) in enumerate(zip(two["losses"], one["losses"])):
            assert sorted(a) == sorted(b), i
            for k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=DP_REL, err_msg=f"step {i} {k}")
        assert _rel(_flat(two["grads"]), _flat(one["grads"])) < tol
        assert _rel(_flat(two["state"]), _flat(one["state"])) < tol


def test_step_matches_jax_mesh(group):
    """(ii) The world-2 steps against the JAX make_train_step on a 2-device
    data axis (GSPMD's psum), at test_torch_train.py's pins."""
    import jax
    import jax.numpy as jnp

    from eonerf_code_tpu.config import TrainConfig as JaxConfig
    from eonerf_code_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from eonerf_code_tpu.render import satellite as jsat
    from eonerf_code_tpu.train import loop as jloop
    from eonerf_code_tpu_torch.interop.jax_params import jax_params_from_field_state
    from test_torch_train import DISPLACEMENT_REL_L2, GRAD_REL_L2, LOSS_RTOL
    from test_torch_train import _flat as flat_tree

    ranks, inputs, (jf, params0, _, _), _ = group
    mesh = make_mesh(n_data=WORLD)
    jcfg = JaxConfig(lr=5e-4, lr_decay_steps=2, batch_size=16)
    jrcfg = jsat.RenderConfig(**RCFG)
    j_opt = jloop.make_optimizer(jcfg, 1)
    j_step = jloop.make_train_step(jf, j_opt, jrcfg, jcfg, **FLAGS)
    j_grad = jax.jit(jax.value_and_grad(jloop.make_loss_fn(jf, jrcfg, **FLAGS), has_aux=True),
                     static_argnums=(4, 5))
    key = jax.random.PRNGKey(0)
    j_params = jax.device_put(jax.tree_util.tree_map(jnp.array, params0), replicate(mesh))
    j_state = jax.device_put(j_opt.init(j_params), replicate(mesh))
    two = ranks[0]["steps"]["float32"]
    for i, ((shadows, use_beta), idx) in enumerate(zip(STEPS, STEP_IDX)):
        j_batch = shard_batch(mesh, {k: jnp.asarray(v[idx]) for k, v in
                                     inputs["step_data"].items()})
        if i == 0:
            (_, _), g_ref = j_grad(j_params, j_batch, key, jnp.float32(100.0), shadows, use_beta)
            g_port = jax_params_from_field_state(two["grads"])
            assert _rel(flat_tree(g_port), flat_tree(g_ref)) < GRAD_REL_L2
        j_params, j_state, j_ld = j_step(j_params, j_state, j_batch, key, jnp.float32(100.0),
                                         shadows, use_beta)
        assert sorted(two["losses"][i]) == sorted(j_ld), i
        for k in j_ld:
            np.testing.assert_allclose(two["losses"][i][k], float(j_ld[k]), rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {k}")
    p0 = flat_tree(jax.tree_util.tree_map(np.asarray, params0))
    j_disp = flat_tree(jax.tree_util.tree_map(np.asarray, j_params)) - p0
    t_disp = flat_tree(jax_params_from_field_state(two["state"])) - p0
    assert np.abs(j_disp).max() > 0
    assert _rel(t_disp, j_disp) < DISPLACEMENT_REL_L2


def _losses(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in rows if r["tag"] == "train/loss"}


def test_trainer_trajectory_matches_world_one(group):
    """(iii) 8 steps with jitter (each rank's draws are its rows of the
    global batch's): the loss trajectory of world 1 at the JAX package's
    weak-scaling pin, and the two ranks' parameters the same bits."""
    ranks, inputs, _, tmp = group
    one = _trainer(inputs, str(tmp / "w1"), 1, "cpu")
    got, want = _losses(str(tmp / "w2" / "dp")), _losses(str(tmp / "w1" / "dp"))
    assert sorted(got) == sorted(want) == list(range(8))
    for s in want:
        np.testing.assert_allclose(got[s], want[s], rtol=TRAJ_RTOL, atol=TRAJ_ATOL, err_msg=s)
    states = [ranks[r]["trainer"]["state"] for r in range(WORLD)]
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])
    assert _rel(_flat(states[0]), _flat(one["state"])) < TRAJ_RTOL


def test_occupancy_gates_agree_across_ranks(group):
    """(iv) Three grid updates: rank 0's grid, occupied fractions and probe
    entropies on both ranks, bit for bit."""
    ranks = group[0]
    a, b = ranks[0]["occ"], ranks[1]["occ"]
    assert len(a["frac_hist"]) == len(a["entropy_hist"]) == 3
    assert torch.equal(a["occs"], b["occs"]) and torch.equal(a["binaries"], b["binaries"])
    assert a["frac_hist"] == b["frac_hist"] and a["entropy_hist"] == b["entropy_hist"]
    assert 0 < a["frac_hist"][-1] <= 1


@pytest.mark.parametrize("reference", ["render_image", "jax"])
def test_render_image_sharded(group, reference):
    """(v) 500 rays in 64-ray chunks over two ranks (a ragged count: rank
    1's run ends in a short block and padding). "render_image": every
    output is render_image's, bit for bit, on both ranks, without jitter
    and with it (rank 1 skips the draws of rank 0's blocks, so its rows'
    jitter is neither rank 0's nor its own stream's first). "jax": the
    depth against the JAX render_image_sharded on a 2-device mesh
    (test_eval_sharded.py's composition)."""
    ranks, inputs, (_, _, rfield, rparams), _ = group
    field, rays = _render_field(inputs, "cpu"), _render_rays(inputs)
    cfg = tsat.RenderConfig(n_samples=8, sc_n_samples=8, perturb=False)
    got = ranks[0]["render"]["plain"]
    if reference == "render_image":
        want = tsat.render_image(field, rays, cfg, True, chunk=RENDER_CHUNK)
        assert sorted(got) == sorted(want)
        for r in range(WORLD):
            for k in want:
                assert torch.equal(ranks[r]["render"]["plain"][k], want[k]), (r, k)
        cfg_p = dataclasses.replace(cfg, perturb=True)
        want_p = tsat.render_image(field, rays, cfg_p, True, chunk=RENDER_CHUNK,
                                   generator=torch.Generator().manual_seed(1))
        for r in range(WORLD):
            for k in want_p:
                assert torch.equal(ranks[r]["render"]["perturbed"][k], want_p[k]), (r, k)
        # the jitter matters: rank 1's rows from a fresh stream differ
        per_rank = -(-N_RENDER // (RENDER_CHUNK * WORLD)) * RENDER_CHUNK
        tail = SatRays(*(x[per_rank:] for x in rays))
        replay = tsat.render_image(field, tail, cfg_p, True, chunk=RENDER_CHUNK,
                                   generator=torch.Generator().manual_seed(1))
        assert not torch.equal(want_p["depth"][per_rank:], replay["depth"])
        return
    import jax
    import jax.numpy as jnp

    from eonerf_code_tpu.data.rays import SatRays as JaxRays
    from eonerf_code_tpu.parallel.mesh import make_mesh
    from eonerf_code_tpu.render.satellite import RenderConfig as JaxRenderConfig
    from eonerf_code_tpu.render.satellite import render_image_sharded

    r = inputs["rays"]
    j_rays = JaxRays(*(jnp.asarray(r[k]) for k in ("o", "d", "sun")),
                     jnp.asarray(r["ts"], jnp.int32), jnp.asarray(r["near"]),
                     jnp.asarray(r["far"]))
    want = render_image_sharded(rfield, rparams, j_rays, jax.random.PRNGKey(5),
                                JaxRenderConfig(n_samples=8, sc_n_samples=8, perturb=False),
                                shadows=True, mesh=make_mesh(n_data=WORLD), chunk=RENDER_CHUNK)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]), rtol=0,
                               atol=DEPTH_TOL)


def test_rank_zero_writes(group):
    """(vi) opts.json once, the checkpoints (epoch=0 at step 4, the final
    epoch=1), the validation at step 4 and the metrics from rank 0; rank 1
    logs nothing, saves nothing and does not validate; the run directory
    holds one set."""
    ranks, _, _, tmp = group
    main, other = ranks[0]["trainer"], ranks[1]["trainer"]
    assert main["calls"] == {"opts": 1, "save_checkpoint": 2, "validate": 1}
    assert other["calls"] == {"opts": 0, "save_checkpoint": 0, "validate": 0}
    assert (main["logger"], other["logger"]) == ("MetricsLogger", "NullLogger")
    run = tmp / "w2" / "dp"
    assert sorted(p.name for p in (run / "ckpts").iterdir()) == ["epoch=0", "epoch=1"]
    for ckpt in (run / "ckpts").iterdir():
        assert sorted(p.name for p in ckpt.iterdir()) == [tloop.OCC_SIDECAR, ckpt_lib.STATE_FILE]
    assert sum(1 for p in run.iterdir() if p.name == "metrics.jsonl") == 1
    assert not list(run.glob("*.tmp")) and not list((run / "ckpts").glob("*/*.tmp"))
