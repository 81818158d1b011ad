"""The port's multi-AOI trainer (parallel/multi_aoi.py) against the JAX
package's MultiAOITrainer on generated scenes (3 views of 32 x 32, as
tests/test_multi_aoi.py), one process, on the CPU. The port's scenes start
from the JAX trainer's stacked initial parameters (``pod_states_from_jax``);
where the two are compared the batch indices are injected and sampling is
without jitter (their random numbers differ).

- (a) the per-sample path at 2x32 float32, (b) the kernel path (the
  kernels' plain versions) at 8x256 float32 against the JAX XLA trainer,
  (c) a scene with depth and shadow priors beside one without: the losses
  of the free-running trajectories, and each step's update from the JAX
  trajectory's parameters and Adam state;
- (d) the learning rate, the PE mask, the all-scenes stability gate and
  the gate ring on the same histories;
- (e) unequal scenes: no draw ever reaches a scene's padding;
- (f) scene 0 beside another scene and alone: the same bits;
- (g) pod resume, 4 + 4 steps against 8: the same bits; the checkpoint's
  gate ring without its sidecar, and a checkpoint without the ring.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eonerf_code_tpu.data.satellite import SatelliteDataset as JaxDataset
from eonerf_code_tpu.data.synthetic import SyntheticSceneSpec, generate_scene
from eonerf_code_tpu.parallel.mesh import make_mesh
from eonerf_code_tpu.parallel.multi_aoi import MultiAOITrainer as JaxTrainer
from eonerf_code_tpu_torch.data.satellite import SatelliteDataset
from eonerf_code_tpu_torch.interop.jax_params import (
    pod_adam_from_jax,
    pod_states_from_jax,
    pod_states_to_jax,
)
from eonerf_code_tpu_torch.models.fused import KernelField
from eonerf_code_tpu_torch.parallel import multi_aoi as tmulti
from eonerf_code_tpu_torch.train import checkpoints as ckpt_lib

# test_torch_train.py's pins for the single-AOI step against the JAX
# package's: the losses, and the parameters after one step from a common
# state. Free-running parameters are not compared: Adam's first steps move
# a parameter by about lr whatever its gradient's size, so a gradient
# component that float32 rounds to opposite signs on the two sides (a sum
# that nearly cancels) moves 2 lr apart, and the trajectories then part
# (2x32, 3 steps: up to 1.4e-4 rel-L2 from such flips, measured on the CPU)
LOSS_RTOL = 1e-5
PARAM_REL_L2 = 1e-4
# the kernel path (b) against the JAX XLA trainer: the plain versions sum in
# the kernels' order, so the flips above are more frequent (one step from a
# common state moved the 8x256 parameters 1.0e-4 rel-L2 from the JAX step's,
# the whole gradient 1.1-1.4e-4, measured on the CPU); the losses are held at
# LOSS_RTOL and the parameters free-running after the two steps at the JAX
# package's own pin for its kernel path (tests/test_multi_aoi.py:118-121;
# measured 1.2e-4 and 4.7e-4)
KERNEL_PARAM_REL_L2 = 5e-3
SMALL = dict(n_samples=16, net_depth=2, net_width=32)


def _scene_dirs(tmp_path_factory, name, specs):
    return [generate_scene(str(tmp_path_factory.mktemp(f"{name}{i}")),
                           SyntheticSceneSpec(n_views=3, n_test_views=1, **spec), aoi_id=aoi)
            for i, (aoi, spec) in enumerate(specs)]


def _datasets(infos, **priors):
    """(JAX datasets, port datasets) of the scenes; ``priors`` per scene."""
    def kw(i):
        return {k: v[i] for k, v in priors.items()}
    return ([JaxDataset(s["root_dir"], s["img_dir"], split="train", **kw(i))
             for i, s in enumerate(infos)],
            [SatelliteDataset(s["root_dir"], s["img_dir"], split="train", **kw(i))
             for i, s in enumerate(infos)])


@pytest.fixture(scope="module")
def two_scenes(tmp_path_factory):
    infos = _scene_dirs(tmp_path_factory, "aoi", [
        ("SYN_100", dict(img_size=32, box_height=20.0, seed=0)),
        ("SYN_200", dict(img_size=32, box_height=10.0, seed=1))])
    return infos, *_datasets(infos)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_state(params, opt_state):
    """(per-scene state dicts, pod Adam state) of a JAX trainer's state."""
    adam = opt_state[0]
    return (pod_states_from_jax(_np(params)),
            pod_adam_from_jax(np.asarray(adam.count), _np(adam.mu), _np(adam.nu)))


def _load(tr, states, adam):
    """Set every scene of port trainer ``tr`` to ``states`` and ``adam``."""
    for j, field in enumerate(tr.fields):
        field.load_state_dict(states[j])
        tmulti.load_adam_state(tr.optimizers[j], field, adam["count"][j],
                               {k: v[j] for k, v in adam["mu"].items()},
                               {k: v[j] for k, v in adam["nu"].items()})


def _flat(state):
    return np.concatenate([state[k].detach().double().cpu().numpy().ravel()
                           for k in sorted(state)])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _pair(jds, tds, use_pallas=False, **kw):
    """A JAX XLA trainer on a 1 x 1 mesh, and two port trainers
    (free-running, teacher-forced) from its initial parameters."""
    jt = JaxTrainer(jds, make_mesh(n_data=1, n_scene=1), perturb=False, **kw)
    ports = [tmulti.MultiAOITrainer(tds, None, perturb=False, device="cpu",
                                    use_pallas=use_pallas, **kw) for _ in range(2)]
    states, adam = _jax_state(jt.params, jt.opt_state)
    for t in ports:
        _load(t, states, adam)
    return jt, ports


def _trajectories(jt, free, forced, steps, seed=0):
    """Run the JAX trainer's ``_multi_step`` and the port's steps on the
    same injected indices. A step gives the JAX losses, the free port's and
    the per-scene rel-L2 of the teacher-forced port's parameters (one step
    from the JAX state) against the JAX parameters after it; then the JAX
    parameters after the last step."""
    rng = np.random.default_rng(seed)
    params, opt = jt.params, jt.opt_state
    out = []
    for step, shadows in enumerate(steps):
        idx = np.stack([rng.integers(0, n, jt.batch_size)
                        for n in jt.n_rays_per_scene]).astype(np.int32)
        states, adam = _jax_state(params, opt)
        _load(forced, states, adam)
        forced.step = step
        keys = jax.random.split(jax.random.PRNGKey(step), jt.n_scenes)
        w_depth = jnp.asarray(jt.depth_weight * jt.depth_weight_decay
                              ** (step // jt._steps_per_epoch), jnp.float32)
        params, opt, j_loss = jt._multi_step(params, opt, jt.data, jnp.asarray(idx), keys,
                                             jt._pe_mask(step), w_depth, shadows)
        t_loss = free.train_steps(1, shadows, idx=idx)
        forced.train_steps(1, shadows, idx=idx)
        want = pod_states_from_jax(_np(params))
        out.append({"jax": np.asarray(j_loss), "port": t_loss.numpy(),
                    "forced": [_rel(_flat(f.state_dict()), _flat(w))
                               for f, w in zip(forced.fields, want)]})
    return out, params


def _check(traj):
    for step, res in enumerate(traj):
        np.testing.assert_allclose(res["port"], res["jax"], rtol=LOSS_RTOL, err_msg=f"step {step}")
        assert max(res["forced"]) < PARAM_REL_L2, (step, res)


def test_per_sample_steps_match_jax(two_scenes):
    """(a) 2x32 float32, three steps (shadows from the second)."""
    _, jds, tds = two_scenes
    jt, (free, forced) = _pair(jds, tds, batch_size=64, **SMALL)
    assert not isinstance(free.render_fields[0], KernelField)
    # the two scenes start apart (fold_in(key, i)) and the bridge keeps them
    states = pod_states_from_jax(_np(jt.params))
    assert not torch.equal(states[0]["trunk.hidden_0.weight"], states[1]["trunk.hidden_0.weight"])
    back = pod_states_to_jax(states)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(_np(jt.params))):
        np.testing.assert_array_equal(a, b)
    _check(_trajectories(jt, free, forced, [False, True, True])[0])


def test_kernel_path_matches_jax_xla(two_scenes):
    """(b) The port's kernel path (KernelField, saved activations; the
    kernels' plain versions on the CPU, float32) at 8x256 against the JAX
    XLA trainer (tests/test_multi_aoi.py's configuration), two shadowed
    steps."""
    _, jds, tds = two_scenes
    jt, (free, forced) = _pair(jds, tds, n_samples=8, batch_size=32, net_depth=8,
                               net_width=256, seed=5, use_pallas=True)
    assert isinstance(free.render_fields[0], KernelField) and free.render_fields[0].save_acts
    traj, params = _trajectories(jt, free, forced, [True, True])
    for step, res in enumerate(traj):
        np.testing.assert_allclose(res["port"], res["jax"], rtol=LOSS_RTOL, err_msg=f"step {step}")
    for got, want in zip(free.fields, pod_states_from_jax(_np(params))):
        assert _rel(_flat(got.state_dict()), _flat(want)) < KERNEL_PARAM_REL_L2


def test_priors_on_one_scene(two_scenes, tmp_path):
    """(c) Scene 0 with a depth prior (its GT DSM) and shadow masks (half the
    image in shadow), scene 1 without: the port's pool holds the neutral
    sentinels for scene 1, and both prior terms train as in the JAX
    package."""
    from PIL import Image

    infos, _, _ = two_scenes
    dsm = os.path.join(infos[0]["gt_dir"], "SYN_100_DSM.tif")
    masks = str(tmp_path / "masks")
    os.makedirs(masks)
    for name in infos[0]["names"]:
        with open(os.path.join(infos[0]["root_dir"], name + ".json")) as f:
            img = json.load(f)["img"]
        m = np.full((32, 32), 255, np.uint8)
        m[:, :16] = 0
        Image.fromarray(m).save(os.path.join(masks, img.replace(".tif", ".png")))
    jds, tds = _datasets(infos, prior_dsm_path=[dsm, None], shadow_masks_dir=[masks, None])
    assert tds[0].prior_depths is not None and tds[0].prior_shadows is not None
    jt, (free, forced) = _pair(jds, tds, batch_size=64, **SMALL)
    n1 = tds[1].all_rays.shape[0]
    assert sorted(free.data) == ["depth_prior", "rays", "rgbs", "shadow_prior", "ts"]
    assert bool((free.data["depth_prior"][1][:n1] == -1.0).all())
    assert bool((free.data["shadow_prior"][1][:n1] == 1.0).all())
    assert 0 < float((free.data["shadow_prior"][0] <= 0.5).float().mean()) < 1
    for k in ("depth_prior", "shadow_prior"):
        np.testing.assert_array_equal(free.data[k].numpy(), np.asarray(jt.data[k]))
    _check(_trajectories(jt, free, forced, [True, True])[0])


@pytest.fixture(scope="module")
def gated(two_scenes):
    """A JAX and a port trainer with tightening, the StepLR schedule and the
    PE annealing, for the host-side rules."""
    _, jds, tds = two_scenes
    kw = dict(n_samples=8, batch_size=32, net_depth=2, net_width=32, lr=1e-3,
              lr_decay_steps=2, occ_enabled=True, occ_tighten=True,
              occ_tighten_start_step=3, n_grid=8, freq_reg_start_step=2, freq_reg_end_step=10)
    return (JaxTrainer(jds, make_mesh(n_data=1, n_scene=1), **kw),
            tmulti.MultiAOITrainer(tds, None, device="cpu", **kw))


HISTORIES = {
    "stable": [np.array([0.20, 0.30], np.float32)] * 5,
    "one_drifts": [np.array([0.20, 0.30 * (1.0 + 0.01 * k)], np.float32) for k in range(5)],
    "short": [np.array([0.20, 0.30], np.float32)] * 4,
    "empty_grid": [np.array([0.0, 0.30], np.float32)] * 5,
    "scatter": [np.array([0.20, 0.30], np.float32)] * 4 + [np.array([0.20, 0.33], np.float32)],
    "long": [np.full(2, v, np.float32) for v in (0.875, 0.75, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5,
                                                 0.5, 0.5)],
}


@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_gates_match_jax(gated, name):
    """(d) The all-scenes stability gate, the gate's verdict around the
    warm-up step and the gate ring, on the same histories."""
    jt, tt = gated
    for tr in (jt, tt):
        tr._occ_frac_hist = list(HISTORIES[name])
    assert tt._grids_stable() == jt._grids_stable()
    for step in (0, 2, 3, 10):
        jt.step = tt.step = step
        assert tt.occ_gate_open() == jt.occ_gate_open(), step
        ring_j, ring_t = jt._gate_pytree(), tt._gate_pytree()
        np.testing.assert_array_equal(ring_t["frac_hist"].numpy(), ring_j["frac_hist"])
        assert ring_t["n_frac"] == int(ring_j["n_frac"])
        assert ring_t["tighten_active"] == int(ring_j["tighten_active"])
    jt.step = tt.step = 0


def test_schedule_and_pe_mask_match_jax(gated, two_scenes):
    """(d) The StepLR rate (constant without lr_decay_steps) and the
    coarse-to-fine mask (all-ones when off) at every step of the ramp."""
    jt, tt = gated
    for step in range(14):
        assert tt.lr_at(step) == pytest.approx(jt.lr_at(step), rel=1e-12)
        np.testing.assert_allclose(tt._pe_mask(step).numpy(), np.asarray(jt._pe_mask(step)),
                                   rtol=0, atol=1e-7)
    assert tt.lr_at(2) == pytest.approx(9e-4) and tt.lr_at(5) == pytest.approx(8.1e-4)
    np.testing.assert_array_equal(tt._pe_mask(0).numpy()[3:], 0.0)
    np.testing.assert_array_equal(tt._pe_mask(10).numpy(), 1.0)
    const = tmulti.MultiAOITrainer(two_scenes[2], None, device="cpu", lr=1e-3, n_samples=8,
                                   batch_size=32, net_depth=2, net_width=32)
    assert const.lr_at(10_000) == pytest.approx(1e-3)
    np.testing.assert_array_equal(const._pe_mask(0).numpy(), 1.0)


@pytest.fixture(scope="module")
def unequal_scenes(tmp_path_factory):
    infos = _scene_dirs(tmp_path_factory, "uaoi", [
        ("SYN_300", dict(img_size=32, seed=10)), ("SYN_400", dict(img_size=24, seed=11))])
    return [SatelliteDataset(s["root_dir"], s["img_dir"], split="train") for s in infos]


def test_unequal_scenes_never_draw_padding(unequal_scenes):
    """(e) Each scene keeps its whole pool, wrap-padded to the largest; the
    padding of the smaller scene, poisoned with NaN, is never drawn: the
    steps stay finite, and every draw of 300 steps lies below the scene's
    true ray count while reaching its top percent."""
    ds = unequal_scenes
    tr = tmulti.MultiAOITrainer(ds, None, device="cpu", batch_size=64, **SMALL)
    n = [d.all_rays.shape[0] for d in ds]
    assert n[0] != n[1]
    np.testing.assert_array_equal(tr.n_rays_per_scene, n)
    assert tr.data["rays"].shape[1] == max(n) == tr.n_rays
    big, small = (0, 1) if n[0] > n[1] else (1, 0)
    np.testing.assert_array_equal(tr.data["rays"][big].numpy(), ds[big].all_rays)
    np.testing.assert_array_equal(tr.data["rays"][small, n[small]:].numpy(),
                                  np.concatenate([ds[small].all_rays] * 2)[n[small]:max(n)])
    tr.data["rays"][small, n[small]:] = float("nan")
    tr.data["rgbs"][small, n[small]:] = float("nan")
    losses = tr.train_steps(3, shadows=True)
    assert bool(torch.isfinite(losses).all())
    assert all(bool(torch.isfinite(p).all()) for f in tr.fields for p in f.parameters())
    for i in (0, 1):
        draws = torch.cat([tr._draw(i, s)[1] for s in range(300)])
        assert int(draws.min()) >= 0 and int(draws.max()) < n[i]
        assert int(draws.max()) > 0.99 * n[i]


def test_scene_beside_another_is_alone(two_scenes):
    """(f) Scene 0 trained beside scene 1 and alone (the same seed, so the
    same initial weights, at the two-scene image count): three steps with
    jitter, shadows from the second, and grid updates: the same parameters,
    Adam state and grid, bit for bit."""
    _, _, tds = two_scenes
    kw = dict(batch_size=64, occ_enabled=True, occ_update_every=1, n_grid=8,
              occ_max_cells=64, seed=7, **SMALL)
    pair = tmulti.MultiAOITrainer(tds, None, device="cpu", **kw)
    alone = tmulti.MultiAOITrainer(tds[:1], None, device="cpu", n_images=pair.n_images, **kw)
    for tr in (pair, alone):
        tr.train_steps(1, shadows=False)
        tr.train_steps(2, shadows=True)
    a, b = pair.state_pytree(), alone.state_pytree()
    for k in a["params"]:
        assert torch.equal(a["params"][k][0], b["params"][k][0]), k
        assert torch.equal(a["opt_state"]["mu"][k][0], b["opt_state"]["mu"][k][0]), k
        assert torch.equal(a["opt_state"]["nu"][k][0], b["opt_state"]["nu"][k][0]), k
    assert torch.equal(a["opt_state"]["count"][:1], b["opt_state"]["count"])
    assert torch.equal(a["occ"]["occs"][0], b["occ"]["occs"][0])
    assert not torch.equal(a["params"]["trunk.hidden_0.weight"][0],
                           a["params"]["trunk.hidden_0.weight"][1])


def _pod_trainer(ds):
    return tmulti.MultiAOITrainer(ds, None, device="cpu", batch_size=64, occ_enabled=True,
                                  occ_tighten=True, occ_tighten_start_step=0,
                                  occ_update_every=2, n_grid=16, occ_max_cells=512, seed=3,
                                  **SMALL)


def test_pod_resume_is_bit_exact(two_scenes, tmp_path):
    """(g) 4 steps, a pod checkpoint, 4 more from it in a new trainer: the
    same state as 8 uninterrupted steps, bit for bit (parameters, Adam,
    grids, the gate history)."""
    _, _, tds = two_scenes
    whole = _pod_trainer(tds)
    whole.train_steps(8, shadows=True)
    first = _pod_trainer(tds)
    first.train_steps(4, shadows=True)
    path = first.save_pod(str(tmp_path / "_pod"))
    assert path.endswith("epoch=4")
    assert sorted(os.listdir(path)) == [tmulti.POD_SIDECAR, ckpt_lib.STATE_FILE]
    resumed = _pod_trainer(tds)
    resumed.restore_pod(path)
    assert resumed.step == 4 and len(resumed._occ_frac_hist) == 2
    resumed.train_steps(4, shadows=True)
    a, b = whole.state_pytree(), resumed.state_pytree()
    for part in ("params", "mu", "nu"):
        src_a = a["params"] if part == "params" else a["opt_state"][part]
        src_b = b["params"] if part == "params" else b["opt_state"][part]
        for k in src_a:
            assert torch.equal(src_a[k], src_b[k]), (part, k)
    assert torch.equal(a["opt_state"]["count"], b["opt_state"]["count"])
    for k in ("occs", "binaries"):
        assert torch.equal(a["occ"][k], b["occ"][k]), k
    np.testing.assert_array_equal(np.stack(whole._occ_frac_hist),
                                  np.stack(resumed._occ_frac_hist))


def test_pod_gate_state_is_self_contained(two_scenes, tmp_path):
    """(g) The pod checkpoint's gate ring: without the sidecar a restore
    sees the same gate tail (and verdict); the sidecar under its old name
    is read; a checkpoint without the ring restores with no history."""
    _, _, tds = two_scenes
    tr = _pod_trainer(tds)
    tr.step = 4
    tr._occ_frac_hist = [np.full(2, v, np.float32)
                         for v in (0.875, 0.75, 0.5, 0.5, 0.5, 0.5, 0.5)]
    assert tr.occ_gate_open()
    path = tr.save_pod(str(tmp_path / "_pod"))
    with open(os.path.join(path, tmulti.POD_SIDECAR)) as f:
        side = json.load(f)
    assert side["tighten_active"] is True and len(side["occ_frac_hist"]) == 7
    os.rename(os.path.join(path, tmulti.POD_SIDECAR), os.path.join(path, "occ_sampling.json"))
    old_name = _pod_trainer(tds)
    old_name.restore_pod(path)
    assert len(old_name._occ_frac_hist) == 7
    os.remove(os.path.join(path, "occ_sampling.json"))
    ring = _pod_trainer(tds)
    ring.restore_pod(path)
    assert ring.step == 4 and ring.occ_gate_open()
    np.testing.assert_array_equal(np.stack(ring._occ_frac_hist),
                                  np.stack(tr._occ_frac_hist[-tr.GATE_HIST_LEN:]))
    state = tr.state_pytree()
    state.pop("gate")
    old = ckpt_lib.save_checkpoint(str(tmp_path / "_pod_old"), "old", state)
    pre_gate = _pod_trainer(tds)
    pre_gate.restore_pod(old)
    assert pre_gate.step == 4 and pre_gate._occ_frac_hist == []


def test_stack_unstack_roundtrip():
    states = [{"a": torch.randn(3, 2), "b": torch.randn(4)} for _ in range(2)]
    stacked = tmulti.stack_params(states)
    assert stacked["a"].shape == (2, 3, 2)
    back = tmulti.unstack_params(stacked, 2)
    assert all(torch.equal(back[i][k], states[i][k]) for i in range(2) for k in states[i])
