"""The plain versions of the port's coarse-weights and density kernels
against the JAX package's Pallas kernels (interpret mode on CPU, float32)
at the full 8x256 width, and the CPU contract of their wrappers and ops."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eonerf_code_tpu.models.eonerf import EONerfField as JaxField
from eonerf_code_tpu.ops.pallas.fused_field import make_fused_density
from eonerf_code_tpu.ops.pallas.fused_field import pack_params as jax_pack_params
from eonerf_code_tpu.ops.pallas.fused_render import make_fused_coarse
from eonerf_code_tpu.ops.sampling import set_last_valid as jax_set_last_valid
from eonerf_code_tpu.ops.volrend import render_weights as jax_render_weights
from eonerf_code_tpu_torch.interop.jax_params import field_state_from_jax
from eonerf_code_tpu_torch.models.eonerf import EONerfField
from eonerf_code_tpu_torch.models.fused import KernelField
from eonerf_code_tpu_torch.ops import fused_field as ff
from eonerf_code_tpu_torch.ops import fused_render as fr
from eonerf_code_tpu_torch.ops.fused_field import pack_params

# the JAX package's own pins: the coarse op against render_weights
# (tests/test_fused_render.py::TestCoarseOp), the density kernel against
# flax (tests/test_pallas_field.py::TestForwardParity)
COARSE_TOL = dict(rtol=2e-5, atol=1e-6)
DENSITY_TOL = dict(rtol=1e-5, atol=1e-6)
# the JAX package's pins for the density op's gradients (its Pallas backward
# against flax, tests/test_pallas_field.py): weights and points
DENSITY_GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
DENSITY_POS_TOL = dict(rtol=1e-3, atol=5e-4)


@pytest.fixture(scope="module")
def setup():
    """8x256 field (flax params and the port's copy); R=12 rays of K=19
    samples, ray 3 without a valid sample; 150 points (a ragged tile)."""
    rng = np.random.default_rng(11)
    jf = JaxField(n_images=6)
    params = jf.init(jax.random.PRNGKey(1), jnp.zeros((2, 3, 3), jnp.float32),
                     jnp.zeros((2, 3), jnp.float32), jnp.zeros((2,), jnp.int32),
                     method="init_all")
    tf = EONerfField(6, device="cpu")
    tf.load_state_dict(field_state_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    r, k = 12, 19
    o = rng.uniform(-0.5, 0.5, (r, 3)).astype(np.float32)
    o[:, 2] = 0.95
    d = np.tile(np.array([0.03, -0.02, -1.0], np.float32), (r, 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.sort(rng.uniform(0.0, 2.0, (r, k)).astype(np.float32), axis=1)
    delta = np.diff(z, axis=1, append=2.2).astype(np.float32)
    mask = rng.random((r, k)) > 0.25
    mask[3] = False
    pos = rng.uniform(-1, 1, (150, 3)).astype(np.float32)
    return jf, params, tf, o, d, z, delta, mask, pos


def _kernel_weights(tf, dtype=torch.float32):
    with torch.no_grad():
        return ff.pack_kernel_weights(pack_params(tf), dtype)


def _coarse_inputs(o, d, z, delta, mask):
    deltam = np.asarray(jax_set_last_valid(jnp.asarray(delta), jnp.asarray(mask), 1e10))
    rayin = np.hstack([o, d, np.zeros((o.shape[0], 10), np.float32)]).astype(np.float32)
    return rayin, deltam.astype(np.float32)


def test_coarse_reference_matches_pallas_and_render_weights(setup):
    """The coarse weights, with the 1e10 sentinel on the last valid sample,
    against make_fused_coarse and against render_weights over the flax
    field's density (the JAX pin)."""
    jf, params, tf, o, d, z, delta, mask, _ = setup
    rayin, deltam = _coarse_inputs(o, d, z, delta, mask)
    got = fr.coarse_forward_reference(_kernel_weights(tf), torch.from_numpy(rayin),
                                      torch.from_numpy(z), torch.from_numpy(deltam * mask))
    assert got.shape == z.shape
    pallas = make_fused_coarse(jnp.float32, interpret=True)(
        jax_pack_params(params), jnp.asarray(rayin), jnp.asarray(z), jnp.asarray(deltam * mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **COARSE_TOL)
    pos = o[:, None, :] + d[:, None, :] * z[..., None]
    sigma = jf.apply(params, jnp.asarray(pos), method="density")
    ref, _, _ = jax_render_weights(sigma, jnp.asarray(deltam), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **COARSE_TOL)
    assert float(got[3].abs().max()) == 0.0        # no valid sample: no weight
    np.testing.assert_allclose(got.sum(dim=1)[mask.any(axis=1)].numpy(), 1.0, atol=1e-5)


def test_density_reference_matches_pallas_and_flax(setup):
    jf, params, tf, _, _, _, _, _, pos = setup
    got = ff.density_forward_reference(_kernel_weights(tf), torch.from_numpy(pos))
    assert got.shape == (pos.shape[0],)
    pallas = make_fused_density(jnp.float32, tile=64, bwd_tile=64, interpret=True)(
        jax_pack_params(params), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **DENSITY_TOL)
    ref = jf.apply(params, jnp.asarray(pos), method="density")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **DENSITY_TOL)


def test_density_is_the_ray_form_at_zero_direction(setup):
    """The per-point PE is the ray form with d = 0, z = 0 bit for bit: the
    density equals the coarse op's sigma at those rays (every sample
    alone, deltam = 1 on a one-sample ray gives 1 - e^-sigma)."""
    _, _, tf, _, _, _, _, _, pos = setup
    kw = _kernel_weights(tf, torch.bfloat16)
    p = torch.from_numpy(pos[:40])
    rayin = torch.cat([p, torch.zeros((40, 13))], dim=1)
    w = fr.coarse_forward_reference(kw, rayin, torch.zeros((40, 1)), torch.ones((40, 1)))
    sigma = ff.density_forward_reference(kw, p)
    assert torch.equal(w[:, 0], 1.0 - torch.exp(-sigma))


def test_wrappers_use_plain_versions_on_cpu(setup):
    """On CPU tensors the wrappers return the plain versions' results and
    launch nothing."""
    _, _, tf, o, d, z, delta, mask, pos = setup
    kw = _kernel_weights(tf, torch.bfloat16)
    rayin, deltam = _coarse_inputs(o, d, z, delta, mask)
    args = (torch.from_numpy(rayin), torch.from_numpy(z), torch.from_numpy(deltam * mask))
    before = (fr.coarse_forward.launches, ff.density_forward.launches)
    assert torch.equal(fr.coarse_forward(kw, *args), fr.coarse_forward_reference(kw, *args))
    p = torch.from_numpy(pos)
    assert torch.equal(ff.density_forward(kw, p), ff.density_forward_reference(kw, p))
    assert (fr.coarse_forward.launches, ff.density_forward.launches) == before


def test_fused_coarse_carries_no_gradient(setup):
    """The coarse op cuts its inputs and its result from autograd, as the
    JAX package's stop_gradient wrapper (TestCoarseOp.test_no_gradient_leak)."""
    _, _, tf, o, d, z, delta, mask, _ = setup
    rayin, deltam = _coarse_inputs(o, d, z, delta, mask)
    kf = KernelField(tf)
    w = kf.pack()
    assert w.mats.requires_grad
    ray = torch.from_numpy(rayin).requires_grad_()
    out = kf.fused_coarse(w, ray, torch.from_numpy(z), torch.from_numpy(deltam * mask))
    assert not out.requires_grad


def test_fused_density_backward_raises(setup):
    """The density op's backward (the JAX package's _density_bwd_kernel,
    plain version on CPU tensors) runs instead of raising: through
    KernelField the gradient of a weighted sum of sigma reaches the field's
    trunk and sigma-head parameters and the points, and equals
    torch.autograd through the plain field's density; no head parameter
    gets a gradient."""
    _, _, tf, _, _, _, _, _, pos = setup
    g = torch.from_numpy(np.random.default_rng(5).normal(size=(10, 15)).astype(np.float32))
    grads = []
    for density in (KernelField(tf).density, tf.density):
        tf.zero_grad(set_to_none=True)
        p = torch.from_numpy(pos).reshape(10, 15, 3).requires_grad_()
        sigma = density(p)
        assert sigma.shape == (10, 15)
        (sigma * g).sum().backward()
        grads.append((p.grad, {n: q.grad for n, q in tf.named_parameters()}))
    (got_pos, got), (ref_pos, ref) = grads
    torch.testing.assert_close(got_pos, ref_pos, **DENSITY_POS_TOL)
    for name, r in ref.items():
        if r is None:
            assert got[name] is None or float(got[name].abs().max()) == 0.0, name
        else:
            torch.testing.assert_close(got[name], r, msg=name, **DENSITY_GRAD_TOL)
    assert float(got["trunk.hidden_0.weight"].abs().max()) > 0
