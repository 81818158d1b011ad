"""The port's fused camera and shadow ops against the JAX package's Pallas
kernels (interpret mode on CPU, float32) at the full 8x256 width, plus the
wrapper contract on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eonerf_code_tpu.models.eonerf import EONerfField as JaxField
from eonerf_code_tpu.ops.pallas.fused_field import pack_params as jax_pack_params
from eonerf_code_tpu.ops.pallas.fused_render import make_fused_camera, make_fused_shadow
from eonerf_code_tpu.ops.sampling import set_last_valid as jax_set_last_valid
from eonerf_code_tpu_torch.interop.jax_params import field_state_from_jax
from eonerf_code_tpu_torch.models.eonerf import EONerfField
from eonerf_code_tpu_torch.ops import fused_field as ff
from eonerf_code_tpu_torch.ops import fused_render as fr
from eonerf_code_tpu_torch.ops.fused_field import pack_params, pad_pe_rows, flatten_weights

# the JAX package's own pins for these kernels against flax
# (tests/test_fused_render.py::TestCameraOp / TestShadowOp)
KERNEL_TOL = dict(rtol=2e-5, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    """8x256 field (flax params and the port's copy), R=12 rays of K=17
    samples, ray 3 with no valid sample."""
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
    return params, tf, o, d, z, delta, mask, emb.astype(np.float32)


def _rayin(o, d, emb):
    return np.hstack([o, d, emb, np.zeros((o.shape[0], 6), np.float32)]).astype(np.float32)


def _kernel_weights(tf, dtype=torch.float32):
    with torch.no_grad():
        return ff.pack_kernel_weights(pack_params(tf), dtype)


def test_camera_reference_matches_pallas(setup):
    params, tf, o, d, z, delta, mask, emb = setup
    deltam = np.asarray(jax_set_last_valid(jnp.asarray(delta), jnp.asarray(mask), 1e10)) * mask
    deltam = deltam.astype(np.float32)
    rayin = _rayin(o, d, emb)
    ref = make_fused_camera(jnp.float32, interpret=True)(
        jax_pack_params(params), jnp.asarray(rayin), jnp.asarray(z), jnp.asarray(deltam))
    got = fr.camera_forward_reference(_kernel_weights(tf), torch.from_numpy(rayin),
                                      torch.from_numpy(z), torch.from_numpy(deltam))
    assert got.shape == (12, fr.ACC_COLS)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **KERNEL_TOL)
    assert float(got[:, 7].abs().max()) == 0.0
    assert float(got[3].abs().max()) == 0.0     # no valid sample: nothing accumulates


def test_shadow_reference_matches_pallas(setup):
    params, tf, o, d, z, delta, mask, _ = setup
    deltam = (delta * mask).astype(np.float32)
    rayin = _rayin(o, d, np.zeros((o.shape[0], 4), np.float32))
    maskf = mask.astype(np.float32)
    ref = make_fused_shadow(jnp.float32, interpret=True)(
        jax_pack_params(params), jnp.asarray(rayin), jnp.asarray(z), jnp.asarray(deltam),
        jnp.asarray(maskf))
    got = fr.shadow_forward_reference(_kernel_weights(tf), torch.from_numpy(rayin),
                                      torch.from_numpy(z), torch.from_numpy(deltam),
                                      torch.from_numpy(maskf))
    assert got.shape == (12,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **KERNEL_TOL)
    assert float(got[3]) == 1.0     # no valid sample: fully lit


def test_wrappers_use_plain_version_on_cpu(setup):
    """On CPU tensors the wrappers return the plain versions' results and
    launch nothing."""
    _, tf, o, d, z, delta, mask, emb = setup
    kw = _kernel_weights(tf, torch.bfloat16)
    args = (torch.from_numpy(_rayin(o, d, emb)), torch.from_numpy(z),
            torch.from_numpy((delta * mask).astype(np.float32)))
    before = (fr.camera_forward.launches, fr.shadow_forward.launches)
    assert torch.equal(fr.camera_forward(kw, *args), fr.camera_forward_reference(kw, *args))
    maskf = torch.from_numpy(mask.astype(np.float32))
    assert torch.equal(fr.shadow_forward(kw, *args, maskf),
                       fr.shadow_forward_reference(kw, *args, maskf))
    assert (fr.camera_forward.launches, fr.shadow_forward.launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_weight_packing_round_trip(setup, dtype):
    """kernel_views(pack_kernel_weights(w)) gives back the padded matrices
    (cast to the compute dtype) and the float32 biases exactly, and the
    packed sizes match the layout the CUDA source indexes."""
    tf = setup[1]
    with torch.no_grad():
        w = pack_params(tf)
    kw = ff.pack_kernel_weights(w, dtype)
    assert kw.mats.shape == (ff.MAT_ELEMENTS,) and kw.biases.shape == (ff.BIAS_ELEMENTS,)
    assert kw.dtype == dtype and kw.biases.dtype == torch.float32
    padded = pad_pe_rows(flatten_weights(w), with_transient=True)
    for a, b in zip(flatten_weights(ff.kernel_views(kw)), padded):
        assert a.shape == b.shape
        assert torch.equal(a.float(), b.to(a.dtype).float())
    # the density prefix (trunk + sigma head) is what the shadow kernel reads
    assert ff.DENSITY_MAT_ELEMENTS == 64 * 256 + 4 * 256 * 256 + 320 * 256 + 2 * 256 * 256 + 256
    assert ff.DENSITY_BIAS_ELEMENTS == 8 * 256 + 1


def test_kpad_and_padding_are_inert(setup):
    """KPAD rounds K up to a multiple of 8, and samples padded with z = 0,
    deltam = 0 leave both ops' outputs unchanged."""
    assert [fr.kpad_of(k) for k in (1, 8, 17, 63, 127, 128)] == [8, 8, 24, 64, 128, 128]
    _, tf, o, d, z, delta, mask, emb = setup
    kw = _kernel_weights(tf)
    rayin = torch.from_numpy(_rayin(o, d, emb))
    z_t = torch.from_numpy(z)
    dm = torch.from_numpy((delta * mask).astype(np.float32))
    m = torch.from_numpy(mask.astype(np.float32))
    pad = lambda x: torch.nn.functional.pad(x, (0, 7))  # noqa: E731
    torch.testing.assert_close(fr.camera_forward_reference(kw, rayin, pad(z_t), pad(dm)),
                               fr.camera_forward_reference(kw, rayin, z_t, dm),
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(fr.shadow_forward_reference(kw, rayin, pad(z_t), pad(dm), pad(m)),
                               fr.shadow_forward_reference(kw, rayin, z_t, dm, m),
                               rtol=1e-6, atol=1e-6)
