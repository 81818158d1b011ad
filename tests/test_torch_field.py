"""The PyTorch port's field modules and weight helpers against the JAX
package: encoder, MLP and EONerfField (float32, 1e-6), the weight bridge,
the kernel weight helpers, and a bfloat16 check of the per-sample field."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eonerf_code_tpu.models.encoders import sinusoidal_encode as jax_encode
from eonerf_code_tpu.models.eonerf import EONerfField as JaxField
from eonerf_code_tpu.models.mlp import MLP as JaxMLP
from eonerf_code_tpu.ops.pallas import fused_field as jff
from eonerf_code_tpu_torch.interop.jax_params import (
    field_state_from_jax,
    jax_params_from_field_state,
)
from eonerf_code_tpu_torch.models.encoders import sinusoidal_encode
from eonerf_code_tpu_torch.models.eonerf import EONerfField
from eonerf_code_tpu_torch.models.mlp import MLP
from eonerf_code_tpu_torch.ops import fused_field as tff

F32_TOL = dict(rtol=1e-6, atol=1e-6)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def make_pair(n_images=5, compute=("float32", jnp.float32, torch.float32), seed=0, **kw):
    """A flax EONerfField with initialised params and the port's field
    loaded with the same weights through the bridge (CPU)."""
    _, jdt, tdt = compute
    jf = JaxField(n_images=n_images, compute_dtype=jdt, **kw)
    params = jf.init(jax.random.PRNGKey(seed), jnp.zeros((2, 3, 3), jnp.float32),
                     jnp.zeros((2, 3), jnp.float32), jnp.zeros((2,), jnp.int32),
                     method="init_all")
    tf = EONerfField(n_images, compute_dtype=tdt, device="cpu", **kw)
    tf.load_state_dict(field_state_from_jax(_np_tree(params)))
    return jf, params, tf


def _field_inputs(seed, r=6, k=5, n_images=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (r, k, 3)).astype(np.float32)
    sun = rng.normal(size=(r, 3)).astype(np.float32)
    sun /= np.linalg.norm(sun, axis=1, keepdims=True)
    idx = rng.integers(0, n_images, r).astype(np.int32)
    return x, sun, idx


@pytest.mark.parametrize("min_deg,max_deg", [(0, 10), (0, 4), (2, 5)])
def test_encoder_matches_jax(min_deg, max_deg):
    x = np.random.default_rng(0).uniform(-1, 1, (7, 9, 3)).astype(np.float32)
    ref = np.asarray(jax_encode(jnp.asarray(x), min_deg, max_deg))
    got = sinusoidal_encode(torch.from_numpy(x), min_deg, max_deg).numpy()
    np.testing.assert_allclose(got, ref, **F32_TOL)


@pytest.mark.parametrize("skip_layer,output_dim", [(4, 5), (None, None)])
def test_mlp_matches_flax(skip_layer, output_dim):
    x = np.random.default_rng(1).normal(size=(11, 13)).astype(np.float32)
    mlp = JaxMLP(output_dim=output_dim, net_depth=6, net_width=32, skip_layer=skip_layer)
    params = mlp.init(jax.random.PRNGKey(3), jnp.asarray(x))
    ref = np.asarray(mlp.apply(params, jnp.asarray(x)))
    state = field_state_from_jax({"params": {"m": _np_tree(params)["params"]}})
    tm = MLP(13, output_dim=output_dim, net_depth=6, net_width=32, skip_layer=skip_layer)
    tm.load_state_dict({k[2:]: v for k, v in state.items()})
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), ref, **F32_TOL)


@pytest.mark.parametrize("rpc_correction,radiometric", [(False, True), (True, False)])
def test_field_matches_flax(rpc_correction, radiometric):
    """Every method of the field at narrow width (depth 6, width 32), f32."""
    kw = dict(net_depth=6, net_width=32, rpc_correction=rpc_correction,
              radiometric_normalization=radiometric)
    jf, params, tf = make_pair(**kw)
    x, sun, idx = _field_inputs(2)
    ref = jf.apply(params, jnp.asarray(x), jnp.asarray(sun), jnp.asarray(idx))
    with torch.no_grad():
        got = tf(torch.from_numpy(x), torch.from_numpy(sun), torch.from_numpy(idx).long())
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **F32_TOL)
        np.testing.assert_allclose(
            tf.density(torch.from_numpy(x)).numpy(),
            np.asarray(jf.apply(params, jnp.asarray(x), method="density")), **F32_TOL)
        np.testing.assert_allclose(
            tf.ambient(torch.from_numpy(sun)).numpy(),
            np.asarray(jf.apply(params, jnp.asarray(sun), method="ambient")), **F32_TOL)
        t_idx = torch.from_numpy(idx).long()
        for g, r in zip(tf.radiometric(t_idx),
                        jf.apply(params, jnp.asarray(idx), method="radiometric")):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **F32_TOL)
        np.testing.assert_allclose(
            tf.ray_offset(t_idx).numpy(),
            np.asarray(jf.apply(params, jnp.asarray(idx), method="ray_offset")), **F32_TOL)


def test_weight_bridge_round_trip():
    """flax tree -> state_dict -> flax tree is exact, and the state_dict
    covers every port parameter (strict load)."""
    _, params, tf = make_pair(rpc_correction=True)
    back = jax_params_from_field_state(tf.state_dict())
    flat_ref = jax.tree_util.tree_leaves_with_path(_np_tree(params))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_back) == len(flat_ref)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat_back[path], leaf)


def test_default_init_matches_jax_scheme():
    """Xavier-uniform matrices, zero biases, N(0, 1) transient embedding,
    identity radiometric rows, zero ray offsets."""
    tf = EONerfField(7, device="cpu", rpc_correction=True,
                     generator=torch.Generator().manual_seed(0))
    w = tf.trunk.hidden_1.weight.detach()
    limit = np.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    assert float(w.abs().max()) <= limit and float(w.abs().max()) > 0.9 * limit
    assert float(tf.trunk.hidden_1.bias.detach().abs().max()) == 0.0
    emb = tf.transient_encoder.weight.detach()
    assert abs(float(emb.std()) - 1.0) < 0.6
    rad = tf.radiometric_enc.weight.detach().numpy()
    np.testing.assert_array_equal(rad, np.tile([1, 1, 1, 0, 0, 0, 0, 0, 0], (7, 1)))
    assert float(tf.ray_correction_enc.weight.detach().abs().max()) == 0.0
    again = EONerfField(7, device="cpu", rpc_correction=True,
                        generator=torch.Generator().manual_seed(0))
    for a, b in zip(tf.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


def test_kernel_weight_helpers_match_jax():
    """pack_params, flatten, density subset, the bf16 cast and the zero-row
    padding give the JAX package's arrays (8x256 field)."""
    _, params, tf = make_pair()
    jw = jff.pack_params(params)
    tw = tff.pack_params(tf)
    j_flat = jff._pad_pe_rows(jff.flatten_weights(jw), with_transient=True)
    t_flat = tff.pad_pe_rows(tff.flatten_weights(tw), with_transient=True)
    assert len(t_flat) == tff.N_WEIGHTS
    for j, t in zip(j_flat, t_flat):
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j))
    assert [tuple(t.shape) for t in tff.density_subset(tw)] == \
        [tuple(j.shape) for j in jff.density_subset(jw)]
    assert len(tff.density_subset(tw)) == tff.N_DENSITY_WEIGHTS
    j_cast = jff.cast_matrices(j_flat, jnp.bfloat16)
    t_cast = tff.cast_matrices(t_flat, torch.bfloat16)
    for j, t in zip(j_cast, t_cast):
        assert (t.dtype == torch.bfloat16) == (j.dtype == jnp.bfloat16)
        np.testing.assert_array_equal(t.detach().float().numpy(), np.asarray(j, np.float32))
    assert tff.unflatten_weights(tff.flatten_weights(tw)) == tw


def test_bf16_per_sample_field_vs_flax():
    """The port's bf16 field follows flax's mixed precision (bf16 inputs,
    weights and bias add, f32 parameters). The two frameworks round at the
    same places but sum in another order, so a bf16 rounding can flip: one
    bf16 ulp is 2^-8 relative (3.9e-3), and the outputs (sigmoid/softplus
    heads of order 1) are held within 3e-2 absolute, 1e-2 on average."""
    jf, params, tf = make_pair(compute=("bfloat16", jnp.bfloat16, torch.bfloat16),
                               net_depth=8, net_width=256)
    x, sun, idx = _field_inputs(4, r=16, k=8)
    ref = jf.apply(params, jnp.asarray(x), jnp.asarray(sun), jnp.asarray(idx))
    with torch.no_grad():
        got = tf(torch.from_numpy(x), torch.from_numpy(sun), torch.from_numpy(idx).long())
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        diff = np.abs(g.float().numpy() - np.asarray(r, np.float32))
        assert diff.max() < 3e-2 and diff.mean() < 1e-2, (diff.max(), diff.mean())
