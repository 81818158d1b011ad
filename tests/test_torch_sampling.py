"""The port's hierarchical sampler pieces against the JAX package's:
``sample_pdf`` (inverse-CDF fine samples from the coarse weights) and
``weight_entropy`` (the entropy gate's per-ray statistic)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eonerf_code_tpu.ops.sampling import sample_pdf as jax_sample_pdf
from eonerf_code_tpu.ops.volrend import weight_entropy as jax_weight_entropy
from eonerf_code_tpu_torch.ops.sampling import sample_pdf
from eonerf_code_tpu_torch.ops.volrend import weight_entropy


def _bins_weights(seed, r, k, empty=False):
    """Sorted edges (r, k+1) and peaked weights (r, k). ``empty``: rays 0-1
    have zero-weight bins (ray 0 all of them, ray 1 all but one)."""
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(0.0, 2.0, (r, k + 1)), axis=1).astype(np.float32)
    weights = (0.01 + rng.random((r, k)) ** 4).astype(np.float32)
    if empty:
        weights[0] = 0.0
        weights[1] = 0.0
        weights[1, k // 2] = 1.0
    return bins, weights


def _jax_draw(bins, weights, n):
    return np.asarray(jax_sample_pdf(jax.random.PRNGKey(0), jnp.asarray(bins),
                                     jnp.asarray(weights), n, perturb=False))


# float64: the two implementations compute the same function. float32: their
# cumulative sums differ by a few ulps (another summation order), and the
# inverse CDF divides that by a bin's probability: 1e-3 of the mass in a bin
# 0.02 wide turns 1e-7 into 2e-6, so z is held at 2e-5 there.
Z_ATOL = {np.float64: 1e-6, np.float32: 2e-5}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("r,k,n", [(9, 11, 8), (16, 95, 48), (5, 4, 17)])
def test_sample_pdf_matches_jax(r, k, n, dtype):
    """perturb=False draws at linspace(0, 1 - 1e-6) in both: the same z
    where every bin holds weight."""
    bins, weights = (a.astype(dtype) for a in _bins_weights(r * k, r, k))
    got = sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), n, perturb=False)
    assert got.shape == (r, n) and got.numpy().dtype == dtype
    np.testing.assert_allclose(got.numpy(), _jax_draw(bins, weights, n), rtol=0,
                               atol=Z_ATOL[dtype])


def test_sample_pdf_zero_weight_bins_land_in_the_jax_bin():
    """In a bin without weight the pdf step is eps / (1 + K eps), within
    rounding of the eps threshold both implementations compare it with, so
    the two cumulative sums (summed in another order) may put a draw at the
    bin's start or inside it. Either way it lands in the same bin, and where
    bins hold weight the draws agree."""
    r, k, n = 8, 24, 16
    bins, weights = _bins_weights(7, r, k, empty=True)
    ref = _jax_draw(bins, weights, n)
    got = sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), n, perturb=False).numpy()
    for i in range(r):
        b = np.searchsorted(bins[i], ref[i], side="right").clip(1, k) - 1
        assert np.all(got[i] >= bins[i][b] - 1e-6) and np.all(got[i] <= bins[i][b + 1] + 1e-6), i
    np.testing.assert_allclose(got[2:], ref[2:], rtol=0, atol=Z_ATOL[np.float32])


def test_perturbed_sample_pdf_follows_the_generator():
    """With jitter the draws come from the generator: one seed, one draw;
    every sample stays inside the bins' range, and where all the mass sits
    in one bin every sample falls in it."""
    bins, weights = _bins_weights(3, 12, 20, empty=True)
    b, w = torch.from_numpy(bins), torch.from_numpy(weights)
    runs = [sample_pdf(b, w, 32, generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    z = runs[0]
    assert bool((z >= b[:, :1]).all()) and bool((z <= b[:, -1:]).all())
    lo, hi = b[1, 10], b[1, 11]
    assert float(((z[1] >= lo) & (z[1] <= hi)).float().mean()) > 0.99


@pytest.mark.parametrize("case", ["delta", "uniform", "floaters", "random"])
def test_weight_entropy_matches_jax(case):
    rng = np.random.default_rng(0)
    w = {"delta": np.eye(32, dtype=np.float32)[[3, 7, 30]] * 0.9,
         "uniform": np.full((3, 32), 1 / 32, np.float32),
         "floaters": np.eye(64, dtype=np.float32)[[40]] * 0.8 + np.eye(64)[[5]] * 0.25,
         "random": rng.random((6, 16)).astype(np.float32)}[case].astype(np.float32)
    got = weight_entropy(torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_weight_entropy(jnp.asarray(w))),
                               rtol=1e-6, atol=1e-6)
    assert bool((got >= 0).all()) and bool((got <= 1 + 1e-6).all())
