"""The port's renderer with the sampler variants against the JAX package's:
hierarchical sampling (the coarse pass through the fused coarse op and
through the per-sample field), occupancy tightening of the camera and the
shadow rays, and the empty-space masking mode, on render_rays,
render_depth and render_image. Sampling without jitter or exploration
(perturb=False, occ_explore_frac=0): the two frameworks draw different
random numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eonerf_code_tpu.data.rays import satrays_from_tensor as jax_satrays
from eonerf_code_tpu.models.eonerf import EONerfField as JaxField
from eonerf_code_tpu.models.fused import PallasField
from eonerf_code_tpu.ops.occupancy import OccupancyGrid as JaxGrid
from eonerf_code_tpu.render import satellite as jsat
from eonerf_code_tpu_torch.data.rays import satrays_from_tensor
from eonerf_code_tpu_torch.interop.jax_params import field_state_from_jax, occ_grid_from_jax
from eonerf_code_tpu_torch.models.eonerf import EONerfField
from eonerf_code_tpu_torch.models.fused import KernelField
from eonerf_code_tpu_torch.ops.occupancy import OccupancyGrid
from eonerf_code_tpu_torch.render import satellite as tsat

# the JAX package's pin for its fused render path against its per-sample
# path (tests/test_fused_render.py::TestRendererDispatch)
RENDER_TOL = dict(rtol=3e-5, atol=2e-5)
HIER = dict(n_samples=12, n_importance=8, sc_n_samples=16, perturb=False)
TIGHT = dict(n_samples=16, sc_n_samples=16, perturb=False, occ_explore_frac=0.0)


@pytest.fixture(scope="module")
def scene():
    """8x256 field (flax params + the port's copy), 24 near-nadir rays over
    the cube, three of them on the default-range fallback."""
    rng = np.random.default_rng(13)
    jf = JaxField(n_images=4)
    params = jf.init(jax.random.PRNGKey(0), jnp.zeros((2, 3, 3), jnp.float32),
                     jnp.zeros((2, 3), jnp.float32), jnp.zeros((2,), jnp.int32),
                     method="init_all")
    tf = EONerfField(4, device="cpu")
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
    rays = np.hstack([o, d, np.zeros((n, 1), np.float32), 2.0 * np.ones((n, 1), np.float32),
                      sun]).astype(np.float32)
    rays[:3, 6] = 2.5       # [near, near + 2] misses the cube: the fallback range
    ts = rng.integers(0, 4, n).astype(np.int32)
    return jf, params, tf, rays, ts


def _rays(rays, ts):
    return (jax_satrays(jnp.asarray(rays), jnp.asarray(ts)),
            satrays_from_tensor(torch.from_numpy(rays), torch.from_numpy(ts)))


def _fields(scene, backend):
    jf, _, tf, _, _ = scene
    if backend == "kernel":
        return PallasField(jf, interpret=True, tile=512, bwd_tile=512), KernelField(tf)
    return jf, tf


def _slab_grid(res=32, z_lo=-0.2, z_hi=0.1):
    """The JAX package's test grid (tests/test_occ_tighten.py): occupied only
    in the slab z in [z_lo, z_hi]; and the port's copy of it."""
    g = JaxGrid.create(res)
    centers = (jnp.arange(res) + 0.5) * g.cell_size() + g.aabb_min
    occ_z = (centers >= z_lo) & (centers <= z_hi)
    g = g.replace(binaries=jnp.broadcast_to(occ_z[None, None, :], (res, res, res)))
    return g, occ_grid_from_jax(np.asarray(g.occs), np.asarray(g.binaries))


def _compare(got, ref, keys=tsat.OUTPUT_KEYS):
    for k in keys:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), err_msg=k, **RENDER_TOL)


@pytest.mark.parametrize("shadows", [True, False])
@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_hierarchical_render_rays_matches_jax(scene, backend, shadows):
    """kernel: the coarse weights from the coarse op's plain version (the
    JAX side: make_fused_coarse in interpret mode); plain: from the
    per-sample density and render_weights. Both draw the same fine z."""
    _, params, _, rays, ts = scene
    j_field, t_field = _fields(scene, backend)
    j_rays, t_rays = _rays(rays, ts)
    ref = jsat.render_rays(j_field, params, j_rays, jax.random.PRNGKey(7),
                           jsat.RenderConfig(**HIER), shadows=shadows)
    with torch.no_grad():
        got = tsat.render_rays(t_field, t_rays, tsat.RenderConfig(**HIER), shadows=shadows)
    _compare(got, ref)
    assert float(got["pts_per_ray"].max()) > HIER["n_samples"] - 1   # fine samples landed


@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_hierarchical_render_depth_matches_jax(scene, backend):
    _, params, _, rays, ts = scene
    j_field, t_field = _fields(scene, backend)
    j_rays, t_rays = _rays(rays, ts)
    ref = jsat.render_depth(j_field, params, j_rays, jax.random.PRNGKey(3),
                            jsat.RenderConfig(**HIER))
    with torch.no_grad():
        got = tsat.render_depth(t_field, t_rays, tsat.RenderConfig(**HIER))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **RENDER_TOL)


@pytest.mark.parametrize("mode", ["camera", "shadow", "both", "mask"])
@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_occupancy_render_rays_matches_jax(scene, backend, mode):
    """camera / shadow / both: the camera rays, the shadow march or both
    sample their occupied span of the slab grid; mask: no tightening, the
    grid masks empty space."""
    _, params, _, rays, ts = scene
    j_field, t_field = _fields(scene, backend)
    j_rays, t_rays = _rays(rays, ts)
    flags = dict(occ_tighten=mode in ("camera", "both"),
                 occ_tighten_shadows=mode in ("shadow", "both"))
    j_grid, t_grid = _slab_grid()
    ref = jsat.render_rays(j_field, params, j_rays, jax.random.PRNGKey(7),
                           jsat.RenderConfig(**TIGHT, **flags), shadows=True, occ_grid=j_grid)
    with torch.no_grad():
        got = tsat.render_rays(t_field, t_rays, tsat.RenderConfig(**TIGHT, **flags), shadows=True,
                               occ_grid=t_grid)
    _compare(got, ref)
    plain = tsat.render_image(t_field, t_rays, tsat.RenderConfig(**TIGHT), shadows=True)
    moved = "geo_shadows" if mode == "shadow" else "depth"
    assert not torch.allclose(got[moved], plain[moved])     # the grid changed the render


@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_tightened_hierarchical_render_depth_matches_jax(scene, backend):
    """Both samplers at once, as an eval of a tightened run with n_importance
    would sample."""
    _, params, _, rays, ts = scene
    j_field, t_field = _fields(scene, backend)
    j_rays, t_rays = _rays(rays, ts)
    j_grid, t_grid = _slab_grid()
    cfg = dict(HIER, occ_tighten=True, occ_explore_frac=0.0)
    ref = jsat.render_depth(j_field, params, j_rays, jax.random.PRNGKey(3),
                            jsat.RenderConfig(**cfg), occ_grid=j_grid)
    with torch.no_grad():
        got = tsat.render_depth(t_field, t_rays, tsat.RenderConfig(**cfg), occ_grid=t_grid)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **RENDER_TOL)


@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_fully_occupied_grid_is_bit_identical(scene, backend):
    """A fully occupied grid tightens every camera ray to its full range, so
    the render equals the grid-less one bit for bit, jitter and exploration
    draws included (the contract of the JAX package's
    tests/test_occ_tighten.py)."""
    _, _, _, rays, ts = scene
    _, t_field = _fields(scene, backend)
    _, t_rays = _rays(rays, ts)
    grid = OccupancyGrid.create(16, device="cpu")
    grid = OccupancyGrid(grid.occs, torch.ones_like(grid.binaries), 16)
    cfg = dict(n_samples=16, sc_n_samples=16)
    with torch.no_grad():
        out_t = tsat.render_rays(t_field, t_rays, tsat.RenderConfig(occ_tighten=True, **cfg),
                                 False, torch.Generator().manual_seed(1), occ_grid=grid)
        out_0 = tsat.render_rays(t_field, t_rays, tsat.RenderConfig(**cfg), False,
                                 torch.Generator().manual_seed(1))
    for k in tsat.OUTPUT_KEYS:
        assert torch.equal(out_t[k], out_0[k]), k


def test_render_image_passes_the_grid_through(scene):
    """The chunk loop with a grid and hierarchical samples equals one block,
    for the full outputs and for depth_only."""
    _, _, tf, rays, ts = scene
    _, t_rays = _rays(rays, ts)
    _, grid = _slab_grid()
    field = KernelField(tf)
    cfg = tsat.RenderConfig(**dict(HIER, occ_tighten=True, occ_tighten_shadows=True,
                                   occ_explore_frac=0.0))
    with torch.no_grad():
        whole = tsat.render_rays(field, t_rays, cfg, True, occ_grid=grid)
        depth = tsat.render_depth(field, t_rays, cfg, occ_grid=grid)
    chunked = tsat.render_image(field, t_rays, cfg, True, chunk=7, occ_grid=grid)
    for k in tsat.OUTPUT_KEYS:
        torch.testing.assert_close(chunked[k], whole[k], rtol=1e-6, atol=1e-6)
    only = tsat.render_image(field, t_rays, cfg, True, chunk=10, occ_grid=grid, depth_only=True)
    torch.testing.assert_close(only["depth"], depth, rtol=1e-6, atol=1e-6)
