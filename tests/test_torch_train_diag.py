"""The per-sample render branch (ray entropy and the nadir diagnostics on)
on the training tests' draw, SCENE_SEED, against the JAX package: its
render gradient in float64 (the port's module against flax), where f32
rounds across a ReLU kink, and a 3-step train-step trajectory of the
port's make_train_step on the kernel-backed field against the JAX
make_train_step on PallasField, float32 (the per-point field and density
ops' plain versions on the CPU against their Pallas kernels in interpret
mode). Sampling without jitter (perturb=False)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eonerf_code_tpu.config import TrainConfig as JaxConfig
from eonerf_code_tpu.data.rays import satrays_from_tensor as jax_satrays
from eonerf_code_tpu.models.eonerf import EONerfField as JaxField
from eonerf_code_tpu.models.fused import PallasField
from eonerf_code_tpu.render import satellite as jsat
from eonerf_code_tpu.train import loop as jloop
from eonerf_code_tpu.utils import metrics as JM
from eonerf_code_tpu_torch.config import TrainConfig
from eonerf_code_tpu_torch.data.rays import satrays_from_tensor
from eonerf_code_tpu_torch.interop.jax_params import (
    field_state_from_jax,
    jax_params_from_field_state,
)
from eonerf_code_tpu_torch.models.eonerf import EONerfField
from eonerf_code_tpu_torch.models.fused import KernelField
from eonerf_code_tpu_torch.render import satellite as tsat
from eonerf_code_tpu_torch.train import loop as tloop
from eonerf_code_tpu_torch.utils import metrics as TM
from tests.test_torch_render_diag import DIAG
from tests.test_torch_train import (
    DISPLACEMENT_REL_L2,
    LOSS_RTOL,
    SCENE_SEED,
    _batches,
    _flat,
    _make_scene,
    _rel,
    _torch_field,
    _torch_grads,
)


@pytest.mark.parametrize("loss", ["uncertainty", "shadow"])
def test_diagnostics_render_gradients_match_jax_in_float64(loss):
    """On the fused branch's draw (SCENE_SEED), where f32 rounds across a
    kink, the two frameworks' per-sample branch computes the same gradient
    away from f32 rounding: the port's module in float64 against the flax
    field in float64, both diagnostics and shadows on."""
    _, params, data = _make_scene(SCENE_SEED, rpc_correction=False)
    jf64 = JaxField(n_images=4, compute_dtype=jnp.float64)
    p64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), params)
    j_rays = jax_satrays(jnp.asarray(data["rays"], jnp.float64), jnp.asarray(data["ts"]))

    def jax_loss(p):
        out = jsat.render_rays(jf64, p, j_rays, jax.random.PRNGKey(7), jsat.RenderConfig(**DIAG),
                               shadows=True)
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
    out = tsat.render_rays(tf, rays, tsat.RenderConfig(**DIAG), shadows=True)
    if loss == "uncertainty":
        l_got = TM.uncertainty_aware_loss(torch.from_numpy(data["rgbs"]).double(), out["rgb"],
                                          out["beta"])[0]
    else:
        l_got = TM.shadow_loss_l2(torch.from_numpy(data["shadow_prior"]).double(),
                                  out["geo_shadows"][:, 0])[0]
    l_got.backward()
    assert _rel(_flat(_torch_grads(tf)), _flat(g_ref)) < 1e-6


def test_diagnostics_train_step_trajectory_matches_jax():
    """Three steps of the port's make_train_step on the kernel-backed field
    with both diagnostics on (the per-sample branch: field and density ops,
    forward and backward) against the JAX make_train_step on PallasField
    with the same RenderConfig, float32, the same batches: the draw and the
    pins of the uniform trajectory test (tests/test_torch_train.py)."""
    jf, params0, data = _make_scene(SCENE_SEED, rpc_correction=False)
    steps = [(False, False), (True, True), (True, True)]
    idx = _batches(24, 16, len(steps))
    jcfg = JaxConfig(lr=5e-4, lr_decay_steps=2, batch_size=16)
    tcfg = TrainConfig(lr=5e-4, lr_decay_steps=2, batch_size=16)
    flags = dict(has_depth=True, has_conf=True, has_shadow=True)
    pf = PallasField(jf, interpret=True, tile=512, bwd_tile=512)
    jrcfg = jsat.RenderConfig(**DIAG)
    j_opt = jloop.make_optimizer(jcfg, 1)
    j_step = jloop.make_train_step(pf, j_opt, jrcfg, jcfg, **flags)
    key = jax.random.PRNGKey(0)
    w_depth = 100.0

    tf = _torch_field(params0)
    t_opt = tloop.make_optimizer(tf.parameters(), tcfg)
    t_step = tloop.make_train_step(KernelField(tf), t_opt, tloop.make_lr_schedule(tcfg, 1),
                                   tsat.RenderConfig(**DIAG), **flags)
    j_params = jax.tree_util.tree_map(jnp.array, params0)   # the JAX step donates its input
    j_state = j_opt.init(j_params)
    for i, ((shadows, use_beta), ix) in enumerate(zip(steps, idx)):
        j_batch = {k: jnp.asarray(v[ix]) for k, v in data.items()}
        t_batch = {k: torch.as_tensor(v[ix]) for k, v in data.items()}
        t_batch["ts"] = t_batch["ts"].long()
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
