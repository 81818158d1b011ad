"""int8_full's trunk-backward plan (ops/fused_render.py ``q8_bwd_plan``, the
mirror of csrc/fused_render.cu's ``eonerf_q8_bwd_plan``): the cotangent
chain's path and cluster on the shapes the port's calls give it, the
kernels' shared-memory carves, the weight gradient's tiles, and the int8
cotangent stream's K-major layout against the plain version's g8. No JAX
and no card; the whole file runs in about a second."""

import numpy as np
import pytest
import torch

from eonerf_code_tpu_torch.models.eonerf import EONerfField
from eonerf_code_tpu_torch.ops import fused_field as ff
from eonerf_code_tpu_torch.ops import fused_render as fr
from eonerf_code_tpu_torch.ops.fused_field import pack_params

# (rays, samples, group target) -> (KPAD, group rows, path, cluster CTAs,
# rows of the group's last CTA): the backwards' training batch (camera K=127
# and the hierarchical 143, shadow 63, the 1024-row target), the card tests'
# 192-row groups, a call smaller than a group, and the layer-major shapes
PLANS = [
    ((1024, 127, 1024), (128, 1024, "cluster", 8, 128)),
    ((1024, 63, 1024), (64, 1024, "cluster", 8, 128)),
    ((1024, 143, 1024), (144, 1152, "cluster", 9, 128)),
    ((37, 17, 256), (24, 192, "cluster", 2, 64)),
    ((96, 63, 512), (64, 512, "cluster", 4, 128)),
    ((3, 127, 1024), (128, 1024, "cluster", 8, 128)),
    ((20, 260, 2048), (264, 2112, "layer_major", 17, 64)),
    ((16, 1024, 2048), (1024, 8192, "layer_major", 64, 128)),
]

# the trunk's packed (out, in) matrices: input widths (PE, h0..h3, [h4 | PE],
# h5, h6), 256 outputs each
TRUNK_IN = (64, 256, 256, 256, 256, 320, 256, 256)


@pytest.mark.parametrize("call,plan", PLANS)
def test_q8_bwd_plan_on_the_calls_shapes(call, plan):
    """The chain takes the trunk's path, with its cluster: one launch a
    call wherever the forward is one."""
    kpad, rt, _ = fr.q8_plan(*call)
    got = fr.q8_bwd_plan(kpad, rt * kpad)
    assert (kpad, rt * kpad, got["path"], got["ctas"], got["last_cta_rows"]) == plan
    assert (got["path"], got["ctas"], got["last_cta_rows"]) == fr.q8_trunk_plan(kpad, rt * kpad)
    assert got["g8_rows"] == -(-rt * kpad // 256) * 256   # whole 256-row chunks


def test_q8_bwd_smem_carves_fit_a_block():
    """Both kernels' shared memory, at layer 5's width (a ring chunk of 320
    input rows), within an H100 block's 232,448 bytes."""
    plan = fr.q8_bwd_plan(128, 1024)
    chain, wgrad = plan["chain_smem"], plan["wgrad_smem"]
    assert chain["ring"] == 4 * 320 * 64 and chain["ring"] % 1024 == 0
    for carve in (chain, wgrad):
        assert carve["total"] == sum(v for k, v in carve.items() if k != "total")
        assert carve["total"] <= fr.SMEM_LIMIT
    assert (chain["total"], wgrad["total"]) == (230976, 229376)


def test_q8_wgrad_tiles_cover_every_trunk_weight_once():
    """q8_wgrad_kernel's 64 x 64 tiles cover each of the 491,520 trunk weight
    elements (the packed (out, in) layout) exactly once."""
    tiles = fr.q8_bwd_plan(128, 1024)["wgrad_tiles"]
    assert len(tiles) == 120 and ff.TRUNK_MAT_ELEMENTS == 491520
    offsets = np.cumsum((0,) + tuple(256 * n for n in TRUNK_IN))
    hits = np.zeros(ff.TRUNK_MAT_ELEMENTS, np.int64)
    for layer, m0, n0 in tiles:
        n, m = np.meshgrid(np.arange(n0, n0 + 64), np.arange(m0, m0 + 64), indexing="ij")
        assert m0 + 64 <= TRUNK_IN[layer] and n0 + 64 <= 256
        np.add.at(hits, offsets[layer] + n * TRUNK_IN[layer] + m, 1)
    assert (hits == 1).all()
    assert [t[0] for t in tiles] == sorted(t[0] for t in tiles)   # layer-major block order


@pytest.mark.parametrize("group_rows,run", [(64, 256), (192, 256), (1024, 1024), (100, 256),
                                            (1152, 1280), (2112, 2304)])
def test_q8_g8_rows(group_rows, run):
    assert fr.q8_g8_rows(group_rows) == run


def _plain_g8(seed, rays, kpad, group_rows):
    """The plain int8_full trunk backward's per-layer g8 (rows x 256) on a
    seeded case: a random PE through a seeded field's int8 trunk, a random
    cotangent back."""
    field = EONerfField(4, compute_dtype=torch.float32, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        kw = ff.pack_kernel_weights(pack_params(field), torch.float32)
    q8 = ff.quantize_kernel_trunk(kw.mats)
    rng = np.random.default_rng(seed)
    rows = rays * kpad
    pe = torch.from_numpy(rng.uniform(-1.0, 1.0, (rows, 64)).astype(np.float32))
    pe[:, 63] = 0.0
    acts, masks, _ = ff.trunk_q8(pe, ff.kernel_views(kw), q8, torch.float32, group_rows)
    g_h = torch.from_numpy(rng.normal(size=(rows, 256)).astype(np.float32))
    return ff.trunk_chain_q8(masks, g_h, q8, torch.float32, [None] * 36, group_rows)[2]


def test_q8_g8_stream_layout_is_k_major():
    """The kernels' int8 cotangent stream restated in numpy: for group G,
    layer L, feature c and the group's row r, the byte
    ((G * 8 + L) * 256 + c) * run + r holds the plain version's g8 of that
    row, layer and feature (the rows of a group contiguous: the weight
    gradient's K); the wrapper's packing and unpacking agree."""
    rays, kpad, group_rows = 16, 8, 64     # two groups of 8 rays
    g8s = _plain_g8(3, rays, kpad, group_rows)
    rows, n_g, run = rays * kpad, rays * kpad // group_rows, fr.q8_g8_rows(group_rows)
    stream = fr.q8_g8_stream(g8s, group_rows).numpy()
    assert stream.shape == (n_g * 8 * 256 * run,) and stream.dtype == np.int8
    want = np.zeros_like(stream)
    for layer, g8 in enumerate(g8s):
        x = g8.numpy().astype(np.int8)
        assert np.abs(x).max() > 0
        for grp in range(n_g):
            feat, r = np.meshgrid(np.arange(256), np.arange(group_rows), indexing="ij")
            want[((grp * 8 + layer) * 256 + feat) * run + r] = x[grp * group_rows + r, feat]
    np.testing.assert_array_equal(stream, want)
    back = fr.q8_g8_layers(torch.from_numpy(stream), rows, group_rows)
    for a, b in zip(back, g8s):
        assert torch.equal(a, b.to(torch.int8))
