"""The int8 trunk's path and cluster plan (ops/fused_render.py
``q8_trunk_plan``, the mirror of csrc/fused_render.cu's ``q8_path``) on the
shapes the port's calls give it, and the trunk-alone wrapper's plain
version. No JAX and no card; the whole file runs in about a second."""

import numpy as np
import pytest
import torch

from eonerf_code_tpu_torch.models.eonerf import EONerfField
from eonerf_code_tpu_torch.ops import fused_field as ff
from eonerf_code_tpu_torch.ops import fused_render as fr
from eonerf_code_tpu_torch.ops.fused_field import pack_params

# (rays, samples, group target) -> (KPAD, group rows, path, cluster CTAs,
# rows of the group's last CTA)
PLANS = [
    ((4096, 127, 2048), (128, 2048, "cluster", 16, 128)),      # camera render chunk
    ((4096, 63, 2048), (64, 2048, "cluster", 16, 128)),        # shadow
    ((4096, 95, 2048), (96, 1536, "cluster", 12, 128)),        # coarse
    ((4096, 143, 2048), (144, 1152, "cluster", 9, 128)),       # hierarchical camera
    ((1024, 127, 1024), (128, 1024, "cluster", 8, 128)),       # camera backward
    ((1024, 63, 1024), (64, 1024, "cluster", 8, 128)),         # shadow backward
    ((37, 17, 256), (24, 192, "cluster", 2, 64)),              # the card tests' 192-row groups
    ((3, 127, 2048), (128, 1024, "cluster", 8, 128)),          # calls smaller than a group
    ((1, 17, 256), (24, 192, "cluster", 2, 64)),
    ((20, 260, 2048), (264, 2112, "layer_major", 17, 64)),     # past 16 CTAs
    ((16, 1024, 2048), (1024, 8192, "layer_major", 64, 128)),  # KPAD 1024
]


@pytest.mark.parametrize("call,plan", PLANS)
def test_q8_trunk_plan_on_the_calls_shapes(call, plan):
    kpad, rt, _ = fr.q8_plan(*call)
    assert (kpad, rt * kpad, *fr.q8_trunk_plan(kpad, rt * kpad)) == plan


def test_q8_trunk_plan_covers_every_group():
    """For every KPAD and group the tier makes: the CTAs cover the group in
    whole 64-row slabs, the last one 64 or 128 rows, and the cluster path
    is taken exactly when they number at most 16."""
    for kpad in range(8, fr.MAX_KPAD + 1, 8):
        for rt in range(8, 8 * 40 + 1, 8):
            path, ctas, last = fr.q8_trunk_plan(kpad, rt * kpad)
            assert 128 * (ctas - 1) + last == rt * kpad and last in (64, 128)
            assert (path == "cluster") == (ctas <= fr.Q8_CLUSTER_MAX)


@pytest.mark.parametrize("kpad,rows", [(100, 200), (fr.MAX_KPAD + 8, 2 * (fr.MAX_KPAD + 8)),
                                       (128, 1000), (128, 0)])
def test_q8_trunk_plan_refuses_shapes_no_call_makes(kpad, rows):
    with pytest.raises(ValueError):
        fr.q8_trunk_plan(kpad, rows)


def test_q8_trunk_plain_version_is_the_forwards_trunk():
    """On the CPU the trunk-alone wrapper runs the forwards' plain trunk: the
    camera forward's group amax, and the columns it names filled (the rest
    zero)."""
    field = EONerfField(4, compute_dtype=torch.float32, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        kw = ff.pack_kernel_weights(pack_params(field), torch.float32)
    q8 = ff.quantize_kernel_trunk(kw.mats)
    rng = np.random.default_rng(0)
    r, k = 11, 17
    rayin = np.zeros((r, fr.RAYIN_COLS), np.float32)
    rayin[:, :3] = rng.uniform(-0.5, 0.5, (r, 3))
    rayin[:, 3:6] = [0.0, 0.0, -1.0]
    z = np.sort(rng.uniform(0.0, 1.0, (r, k)), axis=1).astype(np.float32)
    rayin, z = torch.from_numpy(rayin), torch.from_numpy(z)
    stats = {}
    fr.camera_forward_reference(kw, rayin, z, torch.full_like(z, 0.05), q8, 256, stats)
    for write_all in (False, True):
        stream, amax = fr.q8_trunk(kw, q8, rayin, z, 256, write_all=write_all)
        assert torch.equal(amax, stats["amax"])
        kpad, rt, rp = fr.q8_plan(r, k, 256)
        assert stream.shape == (rp * kpad, 3072) and amax.shape == (rp // rt, 8)
        written = fr.q8_stream_written(stream, write_all)
        assert written.shape[1] == 64 + 256 * (8 if write_all else 1)
        assert float(written[:, -256:].abs().sum()) > 0
        assert int(torch.count_nonzero(stream)) == int(torch.count_nonzero(written))
