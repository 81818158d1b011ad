"""The port's renderer against the JAX package's: render_rays (all 13
keys, shadows on and off) through the kernel-backed field and through the
plain field, render_depth, the chunked render_image, and the nadir virtual
camera. Sampling without jitter (perturb=False): the two frameworks draw
different random numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eonerf_code_tpu.data.rays import satrays_from_tensor as jax_satrays
from eonerf_code_tpu.models.eonerf import EONerfField as JaxField
from eonerf_code_tpu.models.fused import PallasField
from eonerf_code_tpu.render import satellite as jsat
from eonerf_code_tpu.render.nadir import nadir_rays_with_sun as jax_nadir_rays
from eonerf_code_tpu_torch.data.rays import satrays_from_tensor
from eonerf_code_tpu_torch.interop.jax_params import field_state_from_jax
from eonerf_code_tpu_torch.models.eonerf import EONerfField
from eonerf_code_tpu_torch.models.fused import KernelField, make_render_field
from eonerf_code_tpu_torch.render import satellite as tsat
from eonerf_code_tpu_torch.render.nadir import nadir_rays_with_sun

# the JAX package's pin for its fused render path against its per-sample
# path (tests/test_fused_render.py::TestRendererDispatch)
RENDER_TOL = dict(rtol=3e-5, atol=2e-5)


@pytest.fixture(scope="module")
def scene():
    """8x256 field (flax params + the port's copy) and 24 rays over the
    cube, a few with no in-cube sample (the default-range fallback)."""
    rng = np.random.default_rng(9)
    jf = JaxField(n_images=4, rpc_correction=True)
    params = jf.init(jax.random.PRNGKey(0), jnp.zeros((2, 3, 3), jnp.float32),
                     jnp.zeros((2, 3), jnp.float32), jnp.zeros((2,), jnp.int32),
                     method="init_all")
    emb = params["params"]["ray_correction_enc"]["embedding"]
    params["params"]["ray_correction_enc"]["embedding"] = (
        emb + jnp.asarray(rng.normal(0, 0.05, emb.shape), jnp.float32))
    tf = EONerfField(4, rpc_correction=True, device="cpu")
    tf.load_state_dict(field_state_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    n = 24
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = rng.uniform(-0.8, 0.8, n)
    o[:, 1] = rng.uniform(-0.8, 0.8, n)
    o[:, 2] = 0.999
    d = np.tile(np.array([0.05, 0.02, -1.0], np.float32), (n, 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sun = np.tile(np.array([0.3, 0.2, -0.93], np.float32), (n, 1))
    sun /= np.linalg.norm(sun, axis=1, keepdims=True)
    rays_t = np.hstack([o, d, np.zeros((n, 1), np.float32),
                        2.0 * np.ones((n, 1), np.float32), sun]).astype(np.float32)
    rays_t[:3, 6] = 2.5     # [near, near + 2] misses the cube: the fallback range
    ts = rng.integers(0, 4, n).astype(np.int32)
    return jf, params, tf, rays_t, ts


def _rays(rays_t, ts):
    return (jax_satrays(jnp.asarray(rays_t), jnp.asarray(ts)),
            satrays_from_tensor(torch.from_numpy(rays_t), torch.from_numpy(ts)))


CFG = dict(n_samples=16, sc_n_samples=16, perturb=False)


@pytest.mark.parametrize("shadows", [True, False])
@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_render_rays_matches_jax(scene, shadows, backend):
    """kernel: KernelField (plain versions of the fused ops on CPU) vs the
    JAX PallasField in interpret mode; plain: the port's per-sample field vs
    the flax field. All 13 keys."""
    jf, params, tf, rays_t, ts = scene
    j_rays, t_rays = _rays(rays_t, ts)
    if backend == "kernel":
        j_field, t_field = PallasField(jf, interpret=True, tile=512, bwd_tile=512), KernelField(tf)
    else:
        j_field, t_field = jf, tf
    ref = jsat.render_rays(j_field, params, j_rays, jax.random.PRNGKey(7),
                           jsat.RenderConfig(**CFG), shadows=shadows)
    with torch.no_grad():
        got = tsat.render_rays(t_field, t_rays, tsat.RenderConfig(**CFG), shadows=shadows)
    assert sorted(got) == sorted(ref) == sorted(tsat.OUTPUT_KEYS)
    for k in tsat.OUTPUT_KEYS:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), err_msg=k, **RENDER_TOL)


@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_render_depth_matches_jax(scene, backend):
    jf, params, tf, rays_t, ts = scene
    j_rays, t_rays = _rays(rays_t, ts)
    if backend == "kernel":
        j_field, t_field = PallasField(jf, interpret=True, tile=512, bwd_tile=512), KernelField(tf)
    else:
        j_field, t_field = jf, tf
    ref = jsat.render_depth(j_field, params, j_rays, jax.random.PRNGKey(3),
                            jsat.RenderConfig(**CFG))
    with torch.no_grad():
        got = tsat.render_depth(t_field, t_rays, tsat.RenderConfig(**CFG))
    assert got.shape == ref.shape == (rays_t.shape[0], 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **RENDER_TOL)


def test_render_image_chunks_equal_one_block(scene):
    """The chunk loop (uneven last chunk) equals one render_rays call, for
    the full outputs and for depth_only."""
    _, _, tf, rays_t, ts = scene
    _, t_rays = _rays(rays_t, ts)
    field, cfg = KernelField(tf), tsat.RenderConfig(**CFG)
    with torch.no_grad():
        whole = tsat.render_rays(field, t_rays, cfg, shadows=True)
    chunked = tsat.render_image(field, t_rays, cfg, shadows=True, chunk=7)
    for k in tsat.OUTPUT_KEYS:
        torch.testing.assert_close(chunked[k], whole[k], rtol=1e-6, atol=1e-6)
    depth = tsat.render_image(field, t_rays, cfg, shadows=True, chunk=10, depth_only=True)
    assert list(depth) == ["depth"] and depth["depth"].shape == (rays_t.shape[0], 1)


def test_perturbed_sampling_follows_the_generator(scene):
    """With perturb=True the jitter comes from the explicit generator: one
    seed gives one render; the samples stay inside their strata."""
    _, _, tf, rays_t, ts = scene
    _, t_rays = _rays(rays_t, ts)
    cfg = tsat.RenderConfig(n_samples=16, sc_n_samples=16)
    runs = [tsat.render_image(tf, t_rays, cfg, shadows=True,
                              generator=torch.Generator().manual_seed(s))["depth"]
            for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    z_mid, delta, _, _ = tsat._camera_samples(
        t_rays.origins, t_rays.viewdirs, t_rays.t_near, cfg, torch.Generator().manual_seed(0))
    assert bool((delta > 0).all()) and bool((z_mid >= 0).all()) and bool((z_mid <= 2).all())


def test_unported_options_raise(scene):
    """An option the JAX RenderConfig lacks raises. Ray entropy and the
    nadir diagnostics are the JAX RenderConfig's and render: off, both
    outputs are the placeholder ones; on, the kernel-backed field takes the
    per-sample branch and both lie in their ranges (entropy in
    [0, log10(K)], the probes' mean alpha in [0, 1])."""
    with pytest.raises(TypeError):
        tsat.RenderConfig(n_fine=8)
    _, _, tf, rays_t, ts = scene
    _, t_rays = _rays(rays_t, ts)
    kf = KernelField(tf)
    off = tsat.RenderConfig(n_samples=16, sc_n_samples=16, perturb=False)
    on = tsat.RenderConfig(n_samples=16, sc_n_samples=16, perturb=False, compute_entropy=True,
                           nadir_diagnostics=True)
    assert not off.compute_entropy and not off.nadir_diagnostics
    with torch.no_grad():
        plain = tsat.render_rays(kf, t_rays, off, shadows=True)
        diag = tsat.render_rays(kf, t_rays, on, shadows=True)
    assert bool((plain["entropy"] == 1.0).all())
    assert bool((plain["opacity_after_surface"] == 1.0).all())
    entropy, after = diag["entropy"], diag["opacity_after_surface"]
    assert entropy.shape == (24, 1) and after.shape == (24, 2)
    assert bool((entropy >= 0).all()) and bool((entropy <= np.log10(15) + 1e-5).all())
    assert bool((after >= 0).all()) and bool((after <= 1).all())
    assert not bool((entropy == 1.0).all()) and not bool((after == 1.0).all())


def test_make_render_field_picks_the_per_sample_path_off_the_card(scene):
    """Kernels only for a bf16 8x256 field on CUDA; on CPU the field itself."""
    tf = scene[2]
    assert make_render_field(tf) is tf
    bf16 = EONerfField(4, compute_dtype=torch.bfloat16, device="cpu")
    assert make_render_field(bf16) is bf16


@pytest.mark.parametrize("frame", [None, "enu"])
def test_nadir_rays_match_jax(frame):
    scale = np.array([210.0, 190.0, 45.0])
    if frame == "enu":
        from eonerf_code_tpu.render.nadir import enu_frame

        frame = enu_frame(np.array([1.1e6, -4.8e6, 4.0e6]))
    ref, h_ref, w_ref = jax_nadir_rays(64, 48, 27.0, 143.0, scale, img_downscale=2.0,
                                       frame=frame)
    got, h, w = nadir_rays_with_sun(64, 48, 27.0, 143.0, scale, img_downscale=2.0, frame=frame)
    assert (h, w) == (h_ref, w_ref) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
