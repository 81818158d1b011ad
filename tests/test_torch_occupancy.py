"""The port's occupancy grid against the JAX package's: ``update`` fed the
JAX package's own random draws and one analytic density in both,
``query`` and ``ray_span``, and a JAX grid carried across with
``occ_grid_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eonerf_code_tpu.ops.occupancy import OccupancyGrid as JaxGrid
from eonerf_code_tpu_torch.interop.jax_params import occ_grid_from_jax
from eonerf_code_tpu_torch.ops.occupancy import OccupancyGrid

RES = 16
STEP = 2.0 / 16     # render_step_size at n_samples = 16


def _density(x, lib):
    """A surface slab at z = 0.1 over a weak haze, west of x = 0.6: cells
    well above, well below and near the threshold."""
    z, xx = x[..., 2], x[..., 0]
    return (60.0 * lib.exp(-((z - 0.1) / 0.12) ** 2) + 0.02 * (1.0 + lib.sin(5.0 * xx))) * (
        xx < 0.6)


def _jax_draws(key, max_cells):
    """The draws OccupancyGrid.update makes from ``key`` (ops/occupancy.py)."""
    n = RES ** 3
    kc, ku = jax.random.split(key)
    idx = (jax.random.randint(kc, (max_cells,), 0, n) if max_cells is not None
           else jnp.arange(n))
    u = jax.random.uniform(ku, (idx.shape[0], 3), dtype=jnp.float32)
    return np.asarray(idx), np.asarray(u)


@pytest.mark.parametrize("max_cells", [None, 1500])
def test_update_matches_jax(max_cells):
    """Two updates (the second decays the first): identical binaries, and
    occs to float rounding. With 1500 of 4096 cells some are drawn twice in
    one update; the last draw wins in both."""
    jg, tg = JaxGrid.create(RES), OccupancyGrid.create(RES, device="cpu")
    dups = 0
    for key in (jax.random.PRNGKey(3), jax.random.PRNGKey(4)):
        jg = jg.update(lambda x: _density(x, jnp), key, STEP, max_cells=max_cells)
        idx, u = _jax_draws(key, max_cells)
        dups += len(idx) - len(np.unique(idx))
        tg = tg.update(lambda x: _density(x, torch), STEP, max_cells=max_cells,
                       idx=torch.from_numpy(idx.astype(np.int64)), u=torch.from_numpy(u.copy()))
        np.testing.assert_array_equal(tg.binaries.numpy(), np.asarray(jg.binaries))
        np.testing.assert_allclose(tg.occs.numpy(), np.asarray(jg.occs), rtol=1e-6, atol=1e-9)
    frac = float(tg.binaries.float().mean())
    assert 0.05 < frac < 0.95, frac
    assert dups > 0 if max_cells else dups == 0


def test_update_draws_from_the_generator():
    """Without injected draws the probes come from the generator: one seed,
    one grid; probed cells only."""
    grids = [OccupancyGrid.create(RES, device="cpu").update(
        lambda x: _density(x, torch), STEP, max_cells=500,
        generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(grids[0].occs, grids[1].occs)
    assert not torch.equal(grids[0].occs, grids[2].occs)
    assert 0 < int((grids[0].occs > 0).sum()) <= 500


@pytest.fixture(scope="module")
def grids():
    jg = JaxGrid.create(RES).update(lambda x: _density(x, jnp), jax.random.PRNGKey(0), STEP)
    return jg, occ_grid_from_jax(np.asarray(jg.occs), np.asarray(jg.binaries))


def test_query_matches_jax(grids):
    jg, tg = grids
    pts = np.random.default_rng(0).uniform(-1.3, 1.3, (500, 3)).astype(np.float32)
    got = tg.query(torch.from_numpy(pts).reshape(50, 10, 3))
    assert got.shape == (50, 10) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy().reshape(-1), np.asarray(jg.query(jnp.asarray(pts))))


@pytest.mark.parametrize("far", ["per_ray", "scalar"])
def test_ray_span_matches_jax(grids, far):
    """Random rays into and past the cube, some missing every occupied cell
    (the full range), spans widened by the margin and clipped."""
    jg, tg = grids
    rng = np.random.default_rng(1)
    n = 64
    o = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    o[:, 2] = 0.999
    d = np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)), -np.ones((n, 1))], axis=1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    near = rng.uniform(0.0, 0.3, n).astype(np.float32)
    f = (near + 2.0).astype(np.float32) if far == "per_ray" else 2.0
    ref = jg.ray_span(jnp.asarray(o), jnp.asarray(d), jnp.asarray(near),
                      jnp.asarray(f) if far == "per_ray" else f)
    got = tg.ray_span(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(near),
                      torch.from_numpy(f) if far == "per_ray" else f)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    full = (got[0] == torch.from_numpy(near))
    assert 0 < int(full.sum()) < n       # some rays tightened, some kept their near plane


def test_occ_grid_from_jax_round_trip(grids):
    jg, tg = grids
    assert tg.resolution == RES and tg.cell_size() == jg.cell_size()
    np.testing.assert_array_equal(tg.binaries.numpy(), np.asarray(jg.binaries))
    np.testing.assert_array_equal(tg.occs.numpy(), np.asarray(jg.occs))
    with pytest.raises(ValueError):
        occ_grid_from_jax(np.zeros(10, np.float32), np.zeros((4, 4, 2), bool))
