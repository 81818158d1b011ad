"""The weight-gradient pass's products and bounds (bench/backward_passes.py,
bench/variants.py) on the CPU: the library yardstick on the two streams of
the kernels' layout, filled from the plain backwards' own operands, against
those backwards' weight gradients, at a few hundred samples; the product
table against the packed layout; the passes' bounds."""

import numpy as np
import pytest
import torch

from eonerf_code_tpu_torch.bench import backward_passes as bp
from eonerf_code_tpu_torch.bench import variants as vr
from eonerf_code_tpu_torch.models.eonerf import EONerfField
from eonerf_code_tpu_torch.ops import fused_field as ff
from eonerf_code_tpu_torch.ops import fused_render as fr
from eonerf_code_tpu_torch.ops.fused_field import pack_params

# the packed index of each ff.outer call of the plain backwards, in call
# order: the camera's heads (t_s, t_beta, transient 3..0, albedo 1, 0,
# bottleneck, sigma), then the trunk 7..0; the shadow's sigma, then the trunk
CALL_ORDER = {True: [16, 17, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0],
              False: [8, 7, 6, 5, 4, 3, 2, 1, 0]}


@pytest.fixture(scope="module")
def weights():
    field = EONerfField(6, compute_dtype=torch.bfloat16, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        return ff.pack_kernel_weights(pack_params(field), torch.bfloat16)


def _rays(r, k, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.6, 0.6, (r, 3))
    o[:, 2] = 0.99
    d = np.array([0.02, 0.01, -1.0]) / np.linalg.norm([0.02, 0.01, -1.0])
    rayin = np.concatenate([o, np.broadcast_to(d, (r, 3)), rng.normal(size=(r, 4)),
                            np.zeros((r, 6))], axis=1)
    z = np.sort(rng.uniform(0.0, 2.0, (r, k)), axis=1)
    dm = np.diff(z, axis=1, append=np.full((r, 1), 2.0))
    return [torch.tensor(x, dtype=torch.float32) for x in (rayin, z, dm)], rng


def _streams(camera, pairs):
    """The activation and cotangent streams in the kernels' layout, each
    product's operands written into its column slices."""
    s = pairs[0][0].shape[0]
    acts = torch.zeros((s, bp.STREAM_COLS[camera][0]), dtype=torch.bfloat16)
    gpre = torch.zeros((s, bp.STREAM_COLS[camera][1]), dtype=torch.bfloat16)
    jobs = bp.wgrad_jobs(camera)
    for (a, g), j in zip(pairs, CALL_ORDER[camera]):
        i, o, ac, gc = jobs[j]
        assert a.shape == (s, i) and g.shape == (s, o), (j, a.shape, g.shape)
        acts[:, ac:ac + i] = a
        gpre[:, gc:gc + o] = g
    return acts, gpre


@pytest.mark.parametrize("camera", [True, False])
def test_wgrad_yardstick_equals_the_plain_backward(weights, monkeypatch, camera):
    """The 18 (camera) or 9 (shadow) torch.mm products on the streams'
    column slices give the plain backward's weight gradients, within f32
    accumulation of the exact bf16 products: |error| <= n 2^-23 sum |a g|
    over the n samples (float64)."""
    r, k = (3, 100) if camera else (4, 63)
    (rayin, z, dm), rng = _rays(r, k, seed=11 if camera else 12)
    pairs = []
    outer = ff.outer
    monkeypatch.setattr(ff, "outer", lambda a, g: pairs.append((a, g)) or outer(a, g))
    if camera:
        gacc = torch.tensor(rng.normal(size=(r, fr.ACC_COLS)), dtype=torch.float32)
        ref = fr.camera_backward_reference(weights, rayin, z, dm, gacc)
    else:
        mask = torch.ones_like(z)
        ggeo = torch.tensor(rng.normal(size=(r,)), dtype=torch.float32)
        ref = fr.shadow_backward_reference(weights, rayin, z, dm, mask, ggeo)
    assert len(pairs) == len(CALL_ORDER[camera])
    acts, gpre = _streams(camera, pairs)
    got = bp.pack_wgrad(bp.wgrad_library(camera, acts, gpre)())
    ops = bp.wgrad_operands(camera, acts, gpre)
    exact = bp.pack_wgrad([a.double().t() @ g.double() for a, g in ops])
    scale = bp.pack_wgrad([a.double().abs().t() @ g.double().abs() for a, g in ops])
    tol = r * k * 2.0 ** -23 * scale
    assert bool(((got.double() - ref[0].double()).abs() <= 2 * tol).all())
    assert bool(((got.double() - exact).abs() <= tol).all())
    assert float(scale.sum()) > 0


@pytest.mark.parametrize("camera", [True, False])
def test_wgrad_jobs_cover_the_packed_matrices(camera):
    """The product table has the packed matrices' shapes, in their order,
    inside the streams' columns."""
    jobs = bp.wgrad_jobs(camera)
    n = ff.MAT_ELEMENTS if camera else ff.DENSITY_MAT_ELEMENTS
    assert sum(i * o for i, o, _, _ in jobs) == n
    assert [(i, o) for i, o, _, _ in jobs] == [tuple(s) for s in ff._MAT_SHAPES[:len(jobs)]]
    a_cols, g_cols = bp.STREAM_COLS[camera]
    assert all(a + i <= a_cols and g + o <= g_cols for i, o, a, g in jobs)
    flat = bp.pack_wgrad([torch.ones((i, o)) for i, o, _, _ in jobs])
    assert flat.shape == (ff.MAT_ELEMENTS,) and float(flat.sum()) == n


def test_pass_bounds_follow_the_streams():
    """The camera backward at 1024 x 128 samples: dgrad and wgrad the same
    operations, wgrad bound by reading its two streams' used columns once
    (3072 + 2950 bf16 a sample: 1.58 GB, about 0.47 ms at 3.35 TB/s), the
    reduction by bytes; the slab's wgrad by bytes too."""
    lay = {"splits": 16, "nblocks": 1024}
    bounds, nbytes = bp.pass_bounds(True, 1024, 128, lay)
    assert bounds["wgrad"][1] == "bytes" and bounds["reduce"][1] == "bytes"
    assert nbytes["wgrad"] == 131072 * 2 * (3072 + 2950) + 16 * ff.MAT_ELEMENTS * 4
    assert 0.46 < bounds["wgrad"][0] < 0.49
    sh, _ = bp.pass_bounds(False, 1024, 64, lay)
    assert sh["wgrad"][1] == "bytes" and sh["wgrad"][0] < bounds["wgrad"][0]
    slab = vr.slab_pass_bounds(1040384)
    assert slab["slab_wgrad"][1] == "bytes" and 2.3 < slab["slab_wgrad"][0] < 2.5
    assert slab["slab_dgrad"][0] > slab["slab_wgrad"][0] > slab["reduce"][0]
