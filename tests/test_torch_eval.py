"""The port's device DSM evaluation and rasteriser against the JAX
package's eval/device.py and ops/raster.py on the same grids."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eonerf_code_tpu.eval.device import device_dsm_mae as jax_dsm_mae
from eonerf_code_tpu.ops.raster import rasterize_pointcloud_jax
from eonerf_code_tpu_torch.eval.device import device_dsm_mae
from eonerf_code_tpu_torch.ops.raster import rasterize_pointcloud


def smooth(rng, n):
    from numpy.lib.stride_tricks import sliding_window_view

    base = rng.standard_normal((n + 8, n + 8)) * 4
    return sliding_window_view(base, (9, 9)).mean(axis=(2, 3)).astype(np.float32)


@pytest.mark.parametrize("size,shift,bias,holes", [
    (240, (3, -2), 5.0, False),
    (200, (2, 4), 2.5, True),
    (130, (-4, 1), -1.0, True),
])
def test_device_dsm_mae_matches_jax(size, shift, bias, holes):
    """Identical integer shift, bias and MAE within 1e-5."""
    rng = np.random.default_rng(size)
    gt = smooth(rng, size)
    pred = (np.roll(gt, shift, axis=(0, 1)) + bias).astype(np.float32)
    if holes:
        pred[10:30, 40:60] = np.nan
        gt[50:55, 5:25] = np.nan
    mae_j, (dx_j, dy_j, b_j) = jax_dsm_mae(jnp.asarray(pred), jnp.asarray(gt))
    mae, (dx, dy, b) = device_dsm_mae(torch.from_numpy(pred), torch.from_numpy(gt))
    assert (dx, dy) == (int(dx_j), int(dy_j)) == (shift[1], shift[0])
    np.testing.assert_allclose(float(b), float(b_j), atol=1e-5)
    np.testing.assert_allclose(float(mae), float(mae_j), atol=1e-5)


def test_identical_grids_give_zero():
    gt = torch.from_numpy(smooth(np.random.default_rng(0), 150))
    mae, (dx, dy, bias) = device_dsm_mae(gt, gt)
    assert (dx, dy) == (0, 0)
    assert abs(float(mae)) < 1e-5 and abs(float(bias)) < 1e-5


@pytest.mark.parametrize("radius", [0, 1, 2])
def test_rasterizer_matches_jax(radius):
    rng = np.random.default_rng(radius)
    e = rng.uniform(-2, 32, 600).astype(np.float32)
    n = rng.uniform(-2, 32, 600).astype(np.float32)
    a = rng.uniform(0, 20, 600).astype(np.float32)
    ref = np.asarray(rasterize_pointcloud_jax(jnp.asarray(e), jnp.asarray(n), jnp.asarray(a),
                                              0.0, 30.0, 1.0, 30, 30, radius=radius))
    got = rasterize_pointcloud(torch.from_numpy(e), torch.from_numpy(n), torch.from_numpy(a),
                               0.0, 30.0, 1.0, 30, 30, radius=radius)
    assert got.shape == (30, 30) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5, equal_nan=True)
    assert np.isnan(ref).any() == bool(torch.isnan(got).any())
