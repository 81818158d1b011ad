"""The port's per-point field and density ops against the JAX package's
Pallas kernels (make_fused_field / make_fused_density, interpret mode on
CPU) at the full 8x256 width: the plain forwards and backwards in float32
at the JAX package's pins (tests/test_pallas_field.py) and in bfloat16, the
plain backwards against torch.autograd through the plain forwards, and the
autograd Functions and wrappers on CPU tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eonerf_code_tpu.models.eonerf import EONerfField as JaxField
from eonerf_code_tpu.ops.pallas.fused_field import flatten_weights as jax_flatten
from eonerf_code_tpu.ops.pallas.fused_field import make_fused_density, make_fused_field
from eonerf_code_tpu.ops.pallas.fused_field import pack_params as jax_pack_params
from eonerf_code_tpu_torch.interop.jax_params import field_state_from_jax
from eonerf_code_tpu_torch.models.eonerf import EONerfField
from eonerf_code_tpu_torch.ops import fused_field as ff
from eonerf_code_tpu_torch.ops.fused_field import flatten_weights, pack_params, unpad_pe_rows

# the JAX package's pins (tests/test_pallas_field.py): its Pallas field and
# density against flax, forward and gradients, float32
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
DENSITY_POS_TOL = dict(rtol=1e-3, atol=5e-4)
# bfloat16, both sides rounding at the same points with f32 sums in another
# order: a sum that lands within rounding of a bf16 boundary rounds the other
# way and travels down the trunk. Outputs are of order 1; held on the worst
# and the mean difference (measured 6.1e-4 and 3.8e-6 on this draw).
BF16_FWD_TOL = {"max_abs": 5e-3, "mean_abs": 1e-4}
# bfloat16 gradients, rel-L2 per tensor: a flipped rounding moves one
# point's cotangent chain (worst tensor 1.3e-2 on this draw, d_pos 9.7e-3).
# The JAX package's own bf16 chain is 0.20 rel-L2 from its float32 one, so
# only bf16 against bf16 is held.
BF16_GRAD_REL_L2 = 3e-2
# plain backward vs torch.autograd through the plain forward, both float32
AUTOGRAD_TOL = dict(rtol=1e-5, atol=1e-5)
N_POINTS = 200          # four 64-row Pallas tiles, the last one ragged


@pytest.fixture(scope="module")
def setup():
    """8x256 field (flax params and the port's copy), 200 points over the
    cube with their per-image embeddings, a random cotangent per op."""
    rng = np.random.default_rng(13)
    jf = JaxField(n_images=6)
    params = jf.init(jax.random.PRNGKey(2), jnp.zeros((2, 3, 3), jnp.float32),
                     jnp.zeros((2, 3), jnp.float32), jnp.zeros((2,), jnp.int32),
                     method="init_all")
    tf = EONerfField(6, device="cpu")
    tf.load_state_dict(field_state_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    pos = rng.uniform(-1, 1, (N_POINTS, 3)).astype(np.float32)
    idx = rng.integers(0, 6, N_POINTS)
    emb = np.asarray(params["params"]["transient_encoder"]["embedding"])[idx]
    g = rng.normal(size=(N_POINTS, ff.FIELD_COLS)).astype(np.float32)
    g[:, 6:] = 0.0
    gd = rng.normal(size=(N_POINTS,)).astype(np.float32)
    with torch.no_grad():
        kw = ff.pack_kernel_weights(pack_params(tf), torch.float32)
    return dict(params=params, kw=kw, pos=pos, idx=idx, emb=emb.astype(np.float32), g=g, gd=gd)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _kw(s, dtype):
    return ff.KernelWeights(s["kw"].mats.to(dtype), s["kw"].biases)


def _jdtype(dtype):
    return jnp.float32 if dtype == torch.float32 else jnp.bfloat16


def _field_grads(d_mats, d_biases):
    """Packed gradients -> the 36 unpadded FieldWeights-order tensors."""
    views = flatten_weights(ff.kernel_views(ff.KernelWeights(d_mats, d_biases)))
    return unpad_pe_rows(views, with_transient=True)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _table(idx, per_point):
    """Per-point embedding gradients scattered back to the table rows."""
    table = np.zeros((6, 4), np.float32)
    np.add.at(table, idx, np.asarray(per_point))
    return table


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_field_forward_reference_matches_pallas(setup, dtype):
    s = setup
    got = ff.field_forward_reference(_kw(s, dtype), _t(s["pos"]), _t(s["emb"]))
    assert got.shape == (N_POINTS, ff.FIELD_COLS) and got.dtype == torch.float32
    assert float(got[:, 6:].abs().max()) == 0.0
    fused = make_fused_field(_jdtype(dtype), tile=64, bwd_tile=64, interpret=True)
    ref = np.concatenate([np.asarray(x).reshape(N_POINTS, -1) for x in fused(
        jax_pack_params(s["params"]), jnp.asarray(s["pos"]), jnp.asarray(s["emb"]))], axis=1)
    if dtype == torch.float32:
        np.testing.assert_allclose(got[:, :6].numpy(), ref, **FWD_TOL)
    else:
        err = np.abs(got[:, :6].numpy() - ref)
        assert err.max() < BF16_FWD_TOL["max_abs"] and err.mean() < BF16_FWD_TOL["mean_abs"], (
            err.max(), err.mean())


def _jax_field_vjp(s, dtype):
    fused = make_fused_field(_jdtype(dtype), tile=64, bwd_tile=64, interpret=True)
    _, vjp = jax.vjp(fused, jax_pack_params(s["params"]), jnp.asarray(s["pos"]),
                     jnp.asarray(s["emb"]))
    g = jnp.asarray(s["g"])
    return vjp((g[:, 0], g[:, 1:4], g[:, 4:5], g[:, 5:6]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_field_backward_reference_matches_pallas(setup, dtype):
    """Every weight gradient, d_pos and the embedding-table gradient (the
    per-point d_emb scattered by image index, as the JAX package's test
    does) against jax.vjp through make_fused_field: float32 at its pins,
    bfloat16 like against like on the relative L2 error."""
    s = setup
    gw, gpos, gemb = _jax_field_vjp(s, dtype)
    d_mats, d_biases, d_pos, d_emb = ff.field_backward_reference(
        _kw(s, dtype), _t(s["pos"]), _t(s["emb"]), _t(s["g"]))
    assert d_pos.shape == (N_POINTS, 3) and d_emb.shape == (N_POINTS, 4)
    pairs = [(got.numpy(), np.asarray(ref)) for got, ref in
             zip(_field_grads(d_mats, d_biases), jax_flatten(gw))]
    pairs += [(d_pos.numpy(), np.asarray(gpos)),
              (_table(s["idx"], d_emb.numpy()), _table(s["idx"], gemb))]
    for i, (got, ref) in enumerate(pairs):
        got = got.reshape(ref.shape)
        if dtype == torch.float32:
            np.testing.assert_allclose(got, ref, err_msg=str(i), **GRAD_TOL)
        else:
            assert _rel_l2(got, ref) < BF16_GRAD_REL_L2, (i, _rel_l2(got, ref))


def test_density_backward_reference_matches_pallas(setup):
    """d_pos and the trunk and sigma-head gradients against jax.vjp through
    make_fused_density at its pins; every head gradient is exactly zero."""
    s = setup
    fused = make_fused_density(jnp.float32, tile=64, bwd_tile=64, interpret=True)
    _, vjp = jax.vjp(fused, jax_pack_params(s["params"]), jnp.asarray(s["pos"]))
    gw, gpos = vjp(jnp.asarray(s["gd"]))
    d_mats, d_biases, d_pos = ff.density_backward_reference(s["kw"], _t(s["pos"]), _t(s["gd"]))
    grads = _field_grads(d_mats, d_biases)
    for i, (got, ref) in enumerate(zip(grads[:ff.N_DENSITY_WEIGHTS], jax_flatten(gw))):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy().reshape(ref.shape), ref, err_msg=str(i),
                                   **GRAD_TOL)
    assert all(float(g.abs().max()) == 0.0 for g in grads[ff.N_DENSITY_WEIGHTS:])
    assert float(d_mats[ff.DENSITY_MAT_ELEMENTS:].abs().max()) == 0.0
    np.testing.assert_allclose(d_pos.numpy(), np.asarray(gpos), **DENSITY_POS_TOL)


@pytest.mark.parametrize("op", ["field", "density"])
def test_backward_reference_matches_autograd(setup, op):
    """Independent of the JAX side: the step-by-step plain backward equals
    torch.autograd through the plain forward (float32)."""
    s = setup
    mats = s["kw"].mats.clone().requires_grad_()
    biases = s["kw"].biases.clone().requires_grad_()
    pos = _t(s["pos"]).requires_grad_()
    emb = _t(s["emb"]).requires_grad_()
    kw = ff.KernelWeights(mats, biases)
    if op == "field":
        (ff.field_forward_reference(kw, pos, emb) * _t(s["g"])).sum().backward()
        ref = ff.field_backward_reference(s["kw"], _t(s["pos"]), _t(s["emb"]), _t(s["g"]))
        got = (mats.grad, biases.grad, pos.grad, emb.grad)
    else:
        (ff.density_forward_reference(kw, pos) * _t(s["gd"])).sum().backward()
        ref = ff.density_backward_reference(s["kw"], _t(s["pos"]), _t(s["gd"]))
        got = (mats.grad, biases.grad, pos.grad)
    for a, b in zip(ref, got):
        torch.testing.assert_close(a, b, **AUTOGRAD_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_functions_give_the_plain_backward(setup, dtype):
    """torch.autograd through fused_field and fused_density (CPU tensors:
    the plain versions) returns exactly the plain backward, float32 for the
    float32 packed weights, and launches nothing."""
    s = setup
    mats = s["kw"].mats.clone().requires_grad_()
    biases = s["kw"].biases.clone().requires_grad_()
    pos = _t(s["pos"]).requires_grad_()
    emb = _t(s["emb"]).requires_grad_()
    kw = ff.KernelWeights(mats, biases)
    counters = (ff.field_forward, ff.field_backward, ff.density_forward, ff.density_backward)
    before = [fn.launches for fn in counters]
    sigma, albedo, t_s, t_beta = ff.fused_field(kw, pos, emb, dtype)
    assert (sigma.shape, albedo.shape, t_s.shape, t_beta.shape) == (
        (N_POINTS,), (N_POINTS, 3), (N_POINTS, 1), (N_POINTS, 1))
    g = _t(s["g"])
    loss = ((sigma * g[:, 0]).sum() + (albedo * g[:, 1:4]).sum() + (t_s * g[:, 4:5]).sum()
            + (t_beta * g[:, 5:6]).sum()
            + (ff.fused_density(kw, pos, dtype) * _t(s["gd"])).sum())
    loss.backward()
    kw_cd = _kw(s, dtype)
    fld = ff.field_backward_reference(kw_cd, _t(s["pos"]), _t(s["emb"]), g)
    den = ff.density_backward_reference(kw_cd, _t(s["pos"]), _t(s["gd"]))
    assert mats.grad.dtype == biases.grad.dtype == torch.float32
    assert torch.equal(mats.grad, fld[0] + den[0]) and torch.equal(biases.grad, fld[1] + den[1])
    assert torch.equal(pos.grad, fld[2] + den[2]) and torch.equal(emb.grad, fld[3])
    assert [fn.launches for fn in counters] == before


def test_wrappers_use_plain_versions_on_cpu(setup):
    """On CPU tensors the four wrappers return their plain versions' results
    and launch nothing; the field's sigma column is the density's."""
    s = setup
    kw = _kw(s, torch.bfloat16)
    pos, emb, g, gd = _t(s["pos"]), _t(s["emb"]), _t(s["g"]), _t(s["gd"])
    counters = (ff.field_forward, ff.field_backward, ff.density_forward, ff.density_backward)
    before = [fn.launches for fn in counters]
    out = ff.field_forward(kw, pos, emb)
    assert torch.equal(out, ff.field_forward_reference(kw, pos, emb))
    assert torch.equal(out[:, 0], ff.density_forward(kw, pos))
    for a, b in zip(ff.field_backward(kw, pos, emb, g),
                    ff.field_backward_reference(kw, pos, emb, g)):
        assert torch.equal(a, b)
    for a, b in zip(ff.density_backward(kw, pos, gd), ff.density_backward_reference(kw, pos, gd)):
        assert torch.equal(a, b)
    assert [fn.launches for fn in counters] == before
