"""The port's coarse-to-fine PE annealing against the JAX package: the mask
math (``barf_alpha``, ``barf_freq_mask``, ``sinusoidal_encode``'s
``freq_mask``), ``mask_trunk_pe`` on ``pack_params``' layout, a mid-ramp
masked render through the kernel-backed field's plain ops against the
JAX ``make_loss_fn(..., pe_mask=)`` on its XLA path (and in float64 on
the per-sample path), three annealed steps of ``make_train_step``, and the
trainer's consumers and ``load_run`` reading the masked view mid-ramp.

Tolerances: the mask math to 1e-7; the render's loss at ``LOSS_RTOL``, its
gradients at ``GRAD_REL_L2`` and, with bundle adjustment, at
``BA_GRAD_REL_L2`` (tests/test_torch_train.py, on its scene draws 122 and
21); float64 at 1e-6; the masked trunk rows' gradients exactly 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eonerf_code_tpu.config import TrainConfig as JaxConfig
from eonerf_code_tpu.models import encoders as jenc
from eonerf_code_tpu.models.eonerf import EONerfField as JaxField
from eonerf_code_tpu.models.freq_reg import mask_trunk_pe as jax_mask_trunk_pe
from eonerf_code_tpu.ops.pallas.fused_field import pack_params as jax_pack_params
from eonerf_code_tpu.render import satellite as jsat
from eonerf_code_tpu.train import loop as jloop
from eonerf_code_tpu_torch.config import TrainConfig
from eonerf_code_tpu_torch.data.synthetic import SyntheticSceneSpec, generate_scene
from eonerf_code_tpu_torch.eval.run import load_run
from eonerf_code_tpu_torch.data.rays import satrays_from_tensor
from eonerf_code_tpu_torch.interop.jax_params import (
    field_state_from_jax,
    jax_params_from_field_state,
)
from eonerf_code_tpu_torch.models import encoders as tenc
from eonerf_code_tpu_torch.models.eonerf import EONerfField
from eonerf_code_tpu_torch.models.freq_reg import (
    PEMaskedField,
    field_weights,
    mask_trunk_pe,
    pe_masked,
)
from eonerf_code_tpu_torch.models.fused import KernelField
from eonerf_code_tpu_torch.ops import occupancy as occ
from eonerf_code_tpu_torch.ops.fused_field import flatten_weights, pack_params
from eonerf_code_tpu_torch.render import satellite as tsat
from eonerf_code_tpu_torch.train import loop as tloop
from tests.test_torch_train import (
    BA_GRAD_REL_L2,
    DISPLACEMENT_REL_L2,
    GRAD_REL_L2,
    LOSS_RTOL,
    RCFG,
    SCENE_SEED,
    _batches,
    _flat,
    _make_scene,
    _rel,
    _torch_field,
    _torch_grads,
)

DEG = 10
# mid-ramp: bands 0-3 on, band 4 half eased in, bands 5-9 off
ALPHA_MID = 4.5
FLAGS = dict(has_depth=True, has_conf=True, has_shadow=True)


def _jax_mask(alpha, dtype=jnp.float32):
    return jenc.barf_freq_mask(jnp.float32(alpha), 3, 0, DEG, dtype=dtype)


def _torch_mask(alpha, dtype=torch.float32):
    return tenc.barf_freq_mask(alpha, 3, 0, DEG, dtype=dtype)


@pytest.mark.parametrize("start,end", [(0, 1000), (100, 500), (0, 1), (7, 11)])
def test_barf_alpha_matches_jax(start, end):
    for step in (0, 1, 6, 7, 9, 99, 100, 250, 333, 499, 500, 1000, 9999):
        got = float(tenc.barf_alpha(step, start, end, DEG))
        want = float(jenc.barf_alpha(step, start, end, DEG))
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=0, err_msg=str(step))


@pytest.mark.parametrize("deg,use_identity", [(10, True), (4, True), (6, False)])
def test_barf_freq_mask_matches_jax(deg, use_identity):
    for alpha in (0.0, 0.3, 1.0, 2.5, 4.99, 5.0, 7.7, float(deg)):
        got = tenc.barf_freq_mask(alpha, 3, 0, deg, use_identity).numpy()
        want = np.asarray(jenc.barf_freq_mask(jnp.float32(alpha), 3, 0, deg, use_identity))
        assert got.shape == want.shape == (tenc.sinusoidal_latent_dim(3, 0, deg, use_identity),)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7, err_msg=str(alpha))
    # the endpoints: the identity only, then everything
    assert tenc.barf_freq_mask(0.0, 3, 0, deg)[3:].abs().max() == 0
    assert torch.equal(tenc.barf_freq_mask(float(deg), 3, 0, deg), torch.ones(3 + 6 * deg))


def test_sinusoidal_encode_with_mask_matches_jax():
    x = np.random.default_rng(0).uniform(-1, 1, (5, 7, 3)).astype(np.float32)
    got = tenc.sinusoidal_encode(torch.from_numpy(x), 0, DEG, freq_mask=_torch_mask(ALPHA_MID))
    want = jenc.sinusoidal_encode(jnp.asarray(x), 0, DEG, freq_mask=_jax_mask(ALPHA_MID))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def field_params():
    jf = JaxField(n_images=4)
    return jf.init(jax.random.PRNGKey(4), jnp.zeros((2, 3, 3), jnp.float32),
                   jnp.zeros((2, 3), jnp.float32), jnp.zeros((2,), jnp.int32), method="init_all")


@pytest.mark.parametrize("alpha", [0.0, ALPHA_MID, float(DEG)])
def test_mask_trunk_pe_matches_jax(field_params, alpha):
    """On pack_params' (in, out) layout: layer 0 on every row, layer 5 (the
    skip concat's) on its last 63 rows, everything else untouched."""
    tf = _torch_field(field_params)
    got = flatten_weights(mask_trunk_pe(pack_params(tf), _torch_mask(alpha)))
    want = jax_pack_params(jax_mask_trunk_pe(field_params, _jax_mask(alpha)))
    want = [*want.trunk_w, *want.trunk_b, want.sigma_w, want.sigma_b, want.bott_w, want.bott_b,
            want.alb_w0, want.alb_b0, want.alb_w1, want.alb_b1, *want.tr_w, *want.tr_b,
            want.ts_w, want.ts_b, want.tb_w, want.tb_b]
    assert len(got) == len(want) == 36
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b), err_msg=str(i))
    raw = flatten_weights(pack_params(tf))
    changed = [i for i, (a, b) in enumerate(zip(got, raw)) if not torch.equal(a, b)]
    assert changed == ([] if alpha == DEG else [0, 5])


def test_mask_trunk_pe_layout_mismatch_raises(field_params):
    tf = _torch_field(field_params)
    with pytest.raises(ValueError, match="PE layout mismatch"):
        mask_trunk_pe(pack_params(tf), torch.ones(60))
    with pytest.raises(ValueError, match="PE layout mismatch"):
        jax_mask_trunk_pe(field_params, jnp.ones(60))


def _jax_batch(data, ix=slice(None)):
    return {k: jnp.asarray(v[ix]) for k, v in data.items()}


def _torch_batch(data, ix=slice(None), dtype=torch.float32):
    out = {k: torch.as_tensor(v[ix]) for k, v in data.items()}
    out["ts"] = out["ts"].long()
    return {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in out.items()}


@pytest.mark.parametrize("loss", ["render", "bundle_adjust"])
def test_masked_render_matches_jax(scene, ba_scene, loss):
    """Loss and whole raw-parameter gradient of a shadowed, beta-loss
    render through the kernel-backed field under a mid-ramp mask, against
    the JAX loss_fn with pe_mask on the flax field; the trunk rows the mask
    zeroes get a gradient of exactly 0."""
    jf, params, data = ba_scene if loss == "bundle_adjust" else scene
    jloss = jloop.make_loss_fn(jf, jsat.RenderConfig(**RCFG), **FLAGS)
    (l_ref, _), g_ref = jax.jit(jax.value_and_grad(jloss, has_aux=True),
                                static_argnums=(4, 5))(
        params, _jax_batch(data), jax.random.PRNGKey(0), jnp.float32(100.0), True, True, None,
        _jax_mask(ALPHA_MID))
    tf = _torch_field(params)
    tloss = tloop.make_loss_fn(KernelField(tf), tsat.RenderConfig(**RCFG), **FLAGS)
    l_got, _ = tloss(_torch_batch(data), 100.0, True, True, None, None, _torch_mask(ALPHA_MID))
    l_got.backward()
    np.testing.assert_allclose(float(l_got.detach()), float(l_ref), rtol=LOSS_RTOL)
    g_got = _torch_grads(tf)
    if loss == "bundle_adjust":
        ba_ref = np.asarray(g_ref["params"]["ray_correction_enc"]["embedding"])
        assert np.abs(ba_ref).max() > 0
        assert _rel(g_got["params"]["ray_correction_enc"]["embedding"], ba_ref) < BA_GRAD_REL_L2
        assert _rel(_flat(g_got), _flat(g_ref)) < BA_GRAD_REL_L2
    else:
        assert _rel(_flat(g_got), _flat(g_ref)) < GRAD_REL_L2
    off = _torch_mask(ALPHA_MID) == 0
    assert int(off.sum()) == 30
    assert tf.trunk.hidden_0.weight.grad[:, off].abs().max() == 0
    assert tf.trunk.hidden_5.weight.grad[:, 256:][:, off].abs().max() == 0
    assert tf.trunk.hidden_0.weight.grad[:, ~off].abs().max() > 0


def test_masked_render_matches_jax_in_float64(scene):
    """Away from f32 rounding: the per-sample path's masked view
    (PEMaskedField, functional_call) against the flax field, float64."""
    _, params, data = scene
    jf64 = JaxField(n_images=4, compute_dtype=jnp.float64)
    p64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), params)
    jloss = jloop.make_loss_fn(jf64, jsat.RenderConfig(**RCFG), **FLAGS)
    batch = {k: (jnp.asarray(v, jnp.float64) if v.dtype == np.float32 else jnp.asarray(v))
             for k, v in data.items()}
    g_ref = jax.jit(jax.grad(lambda p: jloss(p, batch, jax.random.PRNGKey(0), 100.0, True, True,
                                             None, _jax_mask(ALPHA_MID, jnp.float64))[0]))(p64)
    tf = EONerfField(4, compute_dtype=torch.float64, device="cpu")
    tf.load_state_dict(field_state_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    tf = tf.to(torch.float64)
    tloss = tloop.make_loss_fn(tf, tsat.RenderConfig(**RCFG), **FLAGS)
    l_got, _ = tloss(_torch_batch(data, dtype=torch.float64), 100.0, True, True, None, None,
                     _torch_mask(ALPHA_MID, torch.float64))
    l_got.backward()
    assert _rel(_flat(_torch_grads(tf)), _flat(g_ref)) < 1e-6


def test_annealed_train_steps_match_jax(scene):
    """Three steps of make_train_step on the kernel-backed field, each under
    its step's mask (ramp 0 -> 4: alpha 0, 2.5, 5), against the JAX
    make_train_step with the same masks: the gradients at the JAX
    trajectory's parameters, the loss dicts, and the displacement."""
    jf, params0, data = scene
    steps = [(False, False), (True, True), (True, True)]
    idx = _batches(24, 16, len(steps))
    jcfg = JaxConfig(lr=5e-4, lr_decay_steps=2, batch_size=16, freq_reg_end_step=4)
    tcfg = TrainConfig(lr=5e-4, lr_decay_steps=2, batch_size=16, freq_reg_end_step=4)
    jrcfg = jsat.RenderConfig(**RCFG)
    j_opt = jloop.make_optimizer(jcfg, 1)
    j_step = jloop.make_train_step(jf, j_opt, jrcfg, jcfg, **FLAGS)
    j_grad = jax.jit(jax.value_and_grad(jloop.make_loss_fn(jf, jrcfg, **FLAGS), has_aux=True),
                     static_argnums=(4, 5))
    key = jax.random.PRNGKey(0)
    tf = _torch_field(params0)
    t_opt = tloop.make_optimizer(tf.parameters(), tcfg)
    t_step = tloop.make_train_step(KernelField(tf), t_opt, tloop.make_lr_schedule(tcfg, 1),
                                   tsat.RenderConfig(**RCFG), **FLAGS)
    probe = _torch_field(params0)
    t_loss = tloop.make_loss_fn(KernelField(probe), tsat.RenderConfig(**RCFG), **FLAGS)
    j_params = jax.tree_util.tree_map(jnp.array, params0)
    j_state = j_opt.init(j_params)
    masks = []
    for i, ((shadows, use_beta), ix) in enumerate(zip(steps, idx)):
        alpha = jenc.barf_alpha(i, 0, 4, DEG)
        jm, tm = jenc.barf_freq_mask(alpha, 3, 0, DEG), tenc.barf_freq_mask(alpha, 3, 0, DEG)
        masks.append(tm)
        j_batch, t_batch = _jax_batch(data, ix), _torch_batch(data, ix)
        (_, _), g_ref = j_grad(j_params, j_batch, key, jnp.float32(100.0), shadows, use_beta,
                               None, jm)
        probe.load_state_dict(field_state_from_jax(jax.tree_util.tree_map(np.asarray, j_params)))
        probe.zero_grad(set_to_none=True)
        t_loss(t_batch, 100.0, shadows, use_beta, None, None, tm)[0].backward()
        assert _rel(_flat(_torch_grads(probe)), _flat(g_ref)) < GRAD_REL_L2, i
        j_params, j_state, j_ld = j_step(j_params, j_state, j_batch, key, jnp.float32(100.0),
                                         shadows, use_beta, None, jm)
        t_ld = t_step(t_batch, i, 100.0, shadows, use_beta, pe_mask=tm)
        assert sorted(t_ld) == sorted(j_ld), i
        for k in j_ld:
            np.testing.assert_allclose(float(t_ld[k]), float(j_ld[k]), rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {k}")
    p0 = _flat(jax.tree_util.tree_map(np.asarray, params0))
    j_disp = _flat(jax.tree_util.tree_map(np.asarray, j_params)) - p0
    t_disp = _flat(jax_params_from_field_state(tf.state_dict())) - p0
    assert np.abs(j_disp).max() > 0
    assert _rel(t_disp, j_disp) < DISPLACEMENT_REL_L2
    # the rows every step's mask zeroed (bands 5-9) kept their initial bits
    off = torch.stack(masks).amax(0) == 0
    assert int(off.sum()) == 30
    init = _torch_field(params0)
    assert torch.equal(tf.trunk.hidden_0.weight[:, off], init.trunk.hidden_0.weight[:, off])
    assert torch.equal(tf.trunk.hidden_5.weight[:, 256:][:, off],
                       init.trunk.hidden_5.weight[:, 256:][:, off])


@pytest.fixture(scope="module")
def scene():
    return _make_scene(SCENE_SEED, rpc_correction=False)


@pytest.fixture(scope="module")
def ba_scene():
    return _make_scene(21, rpc_correction=True)


@pytest.fixture(scope="module")
def ramp_run(tmp_path_factory):
    """A 2x16 trainer on a generated 2-view 16x16 scene, 6 steps into a
    100-step ramp, with the occupancy grid; its checkpoint at step 6."""
    tmp = tmp_path_factory.mktemp("ramp")
    info = generate_scene(str(tmp / "scene"), SyntheticSceneSpec(n_views=2, n_test_views=1,
                                                                 img_size=16,
                                                                 dsm_resolution=4.0))
    cfg = TrainConfig(root_dir=info["root_dir"], img_dir=info["img_dir"], gt_dir=info["gt_dir"],
                      logs_dir=str(tmp / "logs"), exp_name="ramp", aoi_id=info["aoi_id"],
                      batch_size=64, n_samples=8, net_depth=2, net_width=16, n_grid=16,
                      occ_update_every=3, occ_max_cells=None, val_freq=10 ** 9, chunk=128,
                      sampler="uniform", freq_reg_end_step=100, rpc_correction=True, seed=2)
    tr = tloop.Trainer(cfg, device="cpu")
    tr.run(max_steps=6, log_every=1)
    return tr


def test_consumers_read_the_masked_view_mid_ramp(ramp_run, monkeypatch):
    """Mid-ramp every consumer outside the loss reads the step's masked view
    (the JAX package's tests/test_freq_reg.py:165-206): _reg_params, the
    occupancy update's density, the entropy probe's, the validation render;
    pe_alpha is logged."""
    tr = ramp_run
    assert tr.step == 6 < tr.cfg.freq_reg_end_step
    mask = tr._pe_mask(6)
    want = mask_trunk_pe(pack_params(tr.field), mask)
    got = tr._reg_params()
    assert not torch.equal(got.trunk_w[0], pack_params(tr.field).trunk_w[0])
    assert all(torch.equal(a, b) for a, b in zip(flatten_weights(got), flatten_weights(want)))
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jenc.barf_freq_mask(jenc.barf_alpha(6, 0, 100, DEG), 3, 0, DEG)))
    view = tr._reg_field()
    assert isinstance(view, PEMaskedField) and torch.equal(view.pe_mask, mask)

    seen = []
    update = occ.OccupancyGrid.update

    def spy(self, density, *a, **k):
        seen.append(density)
        return update(self, density, *a, **k)

    monkeypatch.setattr(occ.OccupancyGrid, "update", spy)
    tr._occ_update()
    assert isinstance(seen[-1].__self__, PEMaskedField)
    assert torch.equal(seen[-1].__self__.pe_mask, mask)
    densities = []
    monkeypatch.setattr(PEMaskedField, "density",
                        lambda self, x: densities.append(self.pe_mask) or
                        self._run("density", x))
    tr._weight_entropy()
    assert len(densities) == 1 and torch.equal(densities[0], mask)

    sample = tr.val_ds.get_val_sample(1)
    out = tr.render_view(sample, depth_only=True)
    rays = satrays_from_tensor(torch.as_tensor(sample["rays"]).float(),
                                    torch.as_tensor(sample["ts"]))
    by_hand = [tsat.render_image(f, rays, tr.rcfg_eval, False, chunk=tr.cfg.chunk,
                                 generator=torch.Generator().manual_seed(0), depth_only=True)
               for f in (pe_masked(tr.field, mask), tr.field)]
    assert torch.equal(out["depth"], by_hand[0]["depth"])
    assert not torch.equal(out["depth"], by_hand[1]["depth"])
    # past the ramp: the raw parameters, an all-ones training mask
    assert tr._reg_mask(100) is None and tr._reg_field(100) is tr.render_field
    assert torch.equal(tr._pe_mask(100), torch.ones(63))


def test_load_run_of_a_mid_ramp_checkpoint(ramp_run):
    """load_run of the step-6 checkpoint: its render field carries the
    step's mask and reads, bit for bit, what _reg_params gives at step 6;
    the EONerfField keeps the raw parameters."""
    tr = ramp_run
    _, rf, field = load_run(tr.log_dir, device="cpu")
    assert isinstance(rf, PEMaskedField) and torch.equal(rf.pe_mask, tr._pe_mask(6))
    for a, b in zip(flatten_weights(field_weights(rf)), flatten_weights(tr._reg_params(6))):
        assert torch.equal(a, b)
    for (name, a), b in zip(field.state_dict().items(), tr.field.state_dict().values()):
        assert torch.equal(a, b), name
    with open(f"{tr.log_dir}/metrics.jsonl") as f:
        alpha = [float(line.split('"value": ')[1].split(",")[0]) for line in f
                 if '"train/pe_alpha"' in line]
    assert alpha == sorted(alpha) and len(alpha) == 6 and alpha[-1] == pytest.approx(0.5)


@pytest.mark.parametrize("end,warned", [(0, True), (50, False)])
def test_rpc_correction_without_annealing_warns(tmp_path, capsys, end, warned):
    """The JAX trainer's warning, on stderr: bundle adjustment without the
    coarse-to-fine annealing usually does not converge."""
    from eonerf_code_tpu_torch.data.synthetic_pool import synthetic_ray_pool

    cfg = TrainConfig(logs_dir=str(tmp_path), sampler="uniform", occ_enabled=False,
                      net_depth=2, net_width=16, rpc_correction=True, freq_reg_end_step=end)
    tloop.Trainer(cfg, synthetic_ray_pool(64, 2, "cpu"), 2, device="cpu")
    err = capsys.readouterr().err
    assert ("--rpc_correction without --freq_reg_end_step" in err) == warned
