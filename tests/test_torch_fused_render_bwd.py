"""The port's camera and shadow backward ops against the JAX package's
Pallas backward kernels (``jax.vjp`` of make_fused_camera /
make_fused_shadow, interpret mode on CPU, float32) at the full 8x256 width,
against torch.autograd through the plain forwards, and the autograd
Functions on CPU tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eonerf_code_tpu.models.eonerf import EONerfField as JaxField
from eonerf_code_tpu.ops.pallas.fused_field import flatten_weights as jax_flatten
from eonerf_code_tpu.ops.pallas.fused_field import pack_params as jax_pack_params
from eonerf_code_tpu.ops.pallas.fused_render import make_fused_camera, make_fused_shadow
from eonerf_code_tpu.ops.sampling import set_last_valid as jax_set_last_valid
from eonerf_code_tpu_torch.interop.jax_params import field_state_from_jax
from eonerf_code_tpu_torch.models.eonerf import EONerfField
from eonerf_code_tpu_torch.ops import fused_render as fr
from eonerf_code_tpu_torch.ops.fused_field import flatten_weights, pack_params, unpad_pe_rows

# the JAX package's own pins for these backward kernels
# (tests/test_fused_render.py: TestCameraOp.test_gradients, TestShadowOp)
WEIGHT_TOL = dict(rtol=1e-3, atol=1e-5)
CAM_ORIGIN_TOL = dict(rtol=1e-3, atol=1e-4)
SHADOW_ORIGIN_TOL = dict(rtol=1e-3, atol=1e-5)
EMB_TOL = dict(rtol=1e-3, atol=1e-5)
# plain backward vs torch.autograd through the plain forward, both float32
AUTOGRAD_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    """8x256 field (flax params and the port's copy), R=12 rays of K=17
    samples, ray 3 with no valid sample, a random cotangent per op."""
    rng = np.random.default_rng(5)
    jf = JaxField(n_images=6)
    params = jf.init(jax.random.PRNGKey(0), jnp.zeros((2, 3, 3), jnp.float32),
                     jnp.zeros((2, 3), jnp.float32), jnp.zeros((2,), jnp.int32),
                     method="init_all")
    tf = EONerfField(6, device="cpu")
    tf.load_state_dict(field_state_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    r, k = 12, 17
    o = rng.uniform(-0.5, 0.5, (r, 3)).astype(np.float32)
    o[:, 2] = 0.95
    d = np.tile(np.array([0.03, -0.02, -1.0], np.float32), (r, 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.sort(rng.uniform(0.0, 2.0, (r, k)).astype(np.float32), axis=1)
    delta = np.diff(z, axis=1, append=2.2).astype(np.float32)
    mask = rng.random((r, k)) > 0.25
    mask[3] = False
    idx = rng.integers(0, 6, r)
    emb = np.asarray(params["params"]["transient_encoder"]["embedding"])[idx]
    rayin = np.hstack([o, d, emb, np.zeros((r, 6), np.float32)]).astype(np.float32)
    deltam_cam = (np.asarray(jax_set_last_valid(jnp.asarray(delta), jnp.asarray(mask), 1e10))
                  * mask).astype(np.float32)
    gacc = rng.normal(size=(r, fr.ACC_COLS)).astype(np.float32)
    ggeo = rng.normal(size=(r,)).astype(np.float32)
    with torch.no_grad():
        kw = fr.pack_kernel_weights(pack_params(tf), torch.float32)
    return dict(params=params, kw=kw, rayin=rayin, z=z, mask=mask, idx=idx,
                deltam_cam=deltam_cam, deltam_sh=(delta * mask).astype(np.float32),
                gacc=gacc, ggeo=ggeo)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _field_grads(d_mats, d_biases):
    """Packed gradients -> the 36 unpadded FieldWeights-order tensors."""
    views = flatten_weights(fr.kernel_views(fr.KernelWeights(d_mats, d_biases)))
    return unpad_pe_rows(views, with_transient=True)


def _jax_vjp(op, s, *args):
    """Weight and rayin cotangents of the JAX op (float32, interpret mode)."""
    w = jax_pack_params(s["params"])
    _, vjp = jax.vjp(lambda w_, ri: op(w_, ri, *args[1:-1]), w, jnp.asarray(args[0]))
    return vjp(jnp.asarray(args[-1]))


def _camera_grads(s):
    return fr.camera_backward_reference(s["kw"], _t(s["rayin"]), _t(s["z"]),
                                        _t(s["deltam_cam"]), _t(s["gacc"]))


def _shadow_grads(s):
    return fr.shadow_backward_reference(s["kw"], _t(s["rayin"]), _t(s["z"]), _t(s["deltam_sh"]),
                                        _t(s["mask"].astype(np.float32)), _t(s["ggeo"]))


def test_camera_backward_reference_matches_pallas(setup):
    s = setup
    cam = make_fused_camera(jnp.float32, interpret=True)
    gw, grayin = _jax_vjp(cam, s, s["rayin"], jnp.asarray(s["z"]),
                          jnp.asarray(s["deltam_cam"]), s["gacc"])
    d_mats, d_biases, d_rayin = _camera_grads(s)
    assert d_mats.dtype == d_biases.dtype == d_rayin.dtype == torch.float32
    for got, ref in zip(_field_grads(d_mats, d_biases), jax_flatten(gw)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy().reshape(ref.shape), ref, **WEIGHT_TOL)
    grayin = np.asarray(grayin)
    np.testing.assert_allclose(d_rayin[:, 0:6].numpy(), grayin[:, 0:6], **CAM_ORIGIN_TOL)
    # per-ray embedding gradients scattered back to the table rows
    table = np.zeros((6, 4), np.float32)
    table_ref = np.zeros((6, 4), np.float32)
    np.add.at(table, s["idx"], d_rayin[:, 6:10].numpy())
    np.add.at(table_ref, s["idx"], grayin[:, 6:10])
    np.testing.assert_allclose(table, table_ref, **EMB_TOL)
    assert float(d_rayin[:, 10:].abs().max()) == 0.0
    assert float(d_rayin[3].abs().max()) == 0.0      # no valid sample: no gradient


def test_shadow_backward_reference_matches_pallas(setup):
    s = setup
    sh = make_fused_shadow(jnp.float32, interpret=True)
    gw, grayin = _jax_vjp(sh, s, s["rayin"], jnp.asarray(s["z"]), jnp.asarray(s["deltam_sh"]),
                          jnp.asarray(s["mask"].astype(np.float32)), s["ggeo"])
    d_mats, d_biases, d_rayin = _shadow_grads(s)
    grads = _field_grads(d_mats, d_biases)
    for got, ref in zip(grads, jax_flatten(gw)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy().reshape(ref.shape), ref, **WEIGHT_TOL)
    # head weights get exact zeros
    assert all(float(g.abs().max()) == 0.0 for g in grads[18:])
    np.testing.assert_allclose(d_rayin[:, 0:6].numpy(), np.asarray(grayin)[:, 0:6],
                               **SHADOW_ORIGIN_TOL)
    assert float(d_rayin[:, 6:].abs().max()) == 0.0


@pytest.mark.parametrize("op", ["camera", "shadow"])
def test_backward_reference_matches_autograd(setup, op):
    """Independent of the JAX side: the step-by-step plain backward equals
    torch.autograd through the plain forward (float32)."""
    s = setup
    mats = s["kw"].mats.clone().requires_grad_()
    biases = s["kw"].biases.clone().requires_grad_()
    rayin = _t(s["rayin"]).requires_grad_()
    kw = fr.KernelWeights(mats, biases)
    z = _t(s["z"])
    if op == "camera":
        out = fr.camera_forward_reference(kw, rayin, z, _t(s["deltam_cam"]))
        (out * _t(s["gacc"])).sum().backward()
        ref = _camera_grads(s)
    else:
        out = fr.shadow_forward_reference(kw, rayin, z, _t(s["deltam_sh"]),
                                          _t(s["mask"].astype(np.float32)))
        (out * _t(s["ggeo"])).sum().backward()
        ref = _shadow_grads(s)
    for got, want in zip(ref, (mats.grad, biases.grad, rayin.grad)):
        torch.testing.assert_close(got, want, **AUTOGRAD_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_functions_give_the_plain_backward(setup, dtype):
    """torch.autograd through the autograd.Functions (CPU tensors: the plain
    versions) returns exactly the plain backward, in float32 for the float32
    packed weights, and launches nothing."""
    s = setup
    mats = s["kw"].mats.clone().requires_grad_()
    biases = s["kw"].biases.clone().requires_grad_()
    rayin = _t(s["rayin"]).requires_grad_()
    kw = fr.KernelWeights(mats, biases)
    z, dcam, dsh = _t(s["z"]), _t(s["deltam_cam"]), _t(s["deltam_sh"])
    maskf = _t(s["mask"].astype(np.float32))
    before = (fr.camera_backward.launches, fr.shadow_backward.launches)
    acc = fr.fused_camera(kw, rayin, z, dcam, dtype)
    geo = fr.fused_shadow(kw, rayin, z, dsh, maskf, dtype)
    ((acc * _t(s["gacc"])).sum() + (geo * _t(s["ggeo"])).sum()).backward()
    kw_cd = fr.KernelWeights(s["kw"].mats.to(dtype), s["kw"].biases)
    cam = fr.camera_backward_reference(kw_cd, _t(s["rayin"]), z, dcam, _t(s["gacc"]))
    sh = fr.shadow_backward_reference(kw_cd, _t(s["rayin"]), z, dsh, maskf, _t(s["ggeo"]))
    assert mats.grad.dtype == biases.grad.dtype == torch.float32
    for got, a, b in zip((mats.grad, biases.grad, rayin.grad), cam, sh):
        assert torch.equal(got, a + b)
    assert (fr.camera_backward.launches, fr.shadow_backward.launches) == before
