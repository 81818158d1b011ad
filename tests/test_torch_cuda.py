"""The port's CUDA kernels on the card against their plain PyTorch versions.

Needs a CUDA device and nvcc; skipped without them. The file imports no JAX,
so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from eonerf_code_tpu_torch.models.eonerf import EONerfField
from eonerf_code_tpu_torch.ops import fused_render as fr
from eonerf_code_tpu_torch.ops.fused_field import pack_params

pytestmark = pytest.mark.cuda

# Both sides round to bf16 at the same points but sum in another order, so a
# rounding (2^-8 relative) can flip and travel down the trunk; outputs are
# of order 1.
TOL = {"max_abs": 2e-2, "mean_abs": 2e-3}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def weights(dev):
    field = EONerfField(6, compute_dtype=torch.bfloat16, device=dev,
                        generator=torch.Generator().manual_seed(0))
    return fr.pack_kernel_weights(pack_params(field), torch.bfloat16)


def _inputs(dev, r, k, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.6, 0.6, (r, 3)).astype(np.float32)
    o[:, 2] = 0.99
    d = np.tile(np.array([0.02, 0.01, -1.0], np.float32), (r, 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.sort(rng.uniform(0.0, 2.0, (r, k)), axis=1).astype(np.float32)
    mask = rng.random((r, k)) > 0.2
    mask[min(5, r - 1)] = False
    delta = np.diff(z, axis=1, append=2.0).astype(np.float32)
    emb = rng.normal(size=(r, 4)).astype(np.float32)
    rayin = np.hstack([o, d, emb, np.zeros((r, 6), np.float32)])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    return t(rayin), t(z), t(delta * mask), t(mask)


def _check(got, ref):
    torch.cuda.synchronize()
    err = (got - ref).abs()
    assert bool(torch.isfinite(got).all())
    assert float(err.max()) < TOL["max_abs"] and float(err.mean()) < TOL["mean_abs"], (
        float(err.max()), float(err.mean()))


@pytest.mark.parametrize("r,k", [(37, 17), (64, 63), (33, 127), (9, 200)])
def test_kernels_match_plain_versions(dev, weights, r, k):
    rayin, z, deltam, mask = _inputs(dev, r, k, seed=k)
    n_cam, n_sh = fr.camera_forward.launches, fr.shadow_forward.launches
    _check(fr.camera_forward(weights, rayin, z, deltam),
           fr.camera_forward_reference(weights, rayin, z, deltam))
    geo = fr.shadow_forward(weights, rayin, z, deltam, mask)
    _check(geo, fr.shadow_forward_reference(weights, rayin, z, deltam, mask))
    assert float(geo[5 if r > 5 else r - 1]) == 1.0      # no valid sample: fully lit
    assert (fr.camera_forward.launches, fr.shadow_forward.launches) == (n_cam + 1, n_sh + 1)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev, weights):
    rayin, z, deltam, mask = _inputs(dev, 8, 16, seed=0)
    f32 = fr.KernelWeights(weights.mats.float(), weights.biases)
    with pytest.raises(TypeError):
        fr.camera_forward(f32, rayin, z, deltam)
    with pytest.raises(ValueError):
        fr.camera_forward(weights, rayin[:, :10].contiguous(), z, deltam)
    with pytest.raises(TypeError):
        fr.shadow_forward(weights, rayin, z, deltam, mask.bool())
    assert fr.camera_forward(weights, rayin[:0], z[:0], deltam[:0]).shape == (0, fr.ACC_COLS)
