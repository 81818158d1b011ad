"""The per-point field and density forwards' streamed design without a
card (csrc/fused_render.cu stream_fwd_kernel's point modes): the tiling
that ops/fused_field.py mirrors (``point_fwd_plan``: 128-point tiles in
order, a contiguous range of whole tiles a block of the persistent grid),
the workspace's layout (``point_fwd_layout``), the weight image (the
camera's for the field, the shadow's for the density), and the CPU
wrappers, which stay the plain versions. No JAX and no card; the whole
file runs in a few seconds."""

import numpy as np
import pytest
import torch

from eonerf_code_tpu_torch.ops import fused_field as ff
from eonerf_code_tpu_torch.ops import fused_render as fr
from tests.test_torch_fwd_plan import _stream_as_the_kernel, _weights

POINT_COUNTS = [1, 127, 128, 129, 64512, 130048, 258048, 520192]


def _first_rows_as_the_kernel(n, blocks):
    """pt_first_row of every block and of the grid's end, one at a time in
    the kernel's integer arithmetic."""
    tiles = (n + 127) // 128
    return [min(n, b * tiles // blocks * 128) for b in range(blocks + 1)]


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("n", POINT_COUNTS)
def test_point_tiling_covers_every_point_once(sms, n):
    """Every point lies in exactly one block and one 128-point tile; a
    block's points are one contiguous range of whole tiles (the last tile
    of the last block may be partial), at least one tile a block, and the
    blocks' tile counts differ by at most one."""
    plan = ff.point_fwd_plan(n, sms)
    tiles, blocks, first = plan["tiles"], plan["blocks"], plan["first_row"].numpy()
    assert tiles == -(-n // 128) and blocks == min(sms, ff.STREAM_MAX_BLOCKS, tiles)
    assert first.tolist() == _first_rows_as_the_kernel(n, blocks)
    assert first[0] == 0 and first[-1] == n
    owner = np.repeat(np.arange(blocks), np.diff(first))
    assert len(owner) == n and np.array_equal(owner, np.sort(owner))
    assert all(f % 128 == 0 for f in first[:-1])
    per_block = np.diff(-(-first // 128))
    assert per_block.min() >= 1 and per_block.max() - per_block.min() <= 1
    assert per_block.sum() == tiles
    # a tile's points all lie in the block of its first point
    assert np.array_equal(owner, owner[np.arange(n) // 128 * 128])


@pytest.mark.parametrize("field", [True, False])
def test_point_workspace_layout(field):
    """Each part 256-byte aligned; the weight image fits, the same size as
    the ray forwards' stream part of the same heads."""
    lay = ff.point_fwd_layout(field)
    offs = [lay["stream"], lay["total"]]
    assert all(o % 256 == 0 for o in offs) and offs == sorted(offs)
    nbytes = ff.STREAM_CHUNKS[field] * ff.STREAM_CHUNK_BYTES
    assert lay["total"] - lay["stream"] >= nbytes
    ray = fr.stream_fwd_layout(field, 1, 8)
    assert lay["total"] == ray["res"] - ray["stream"]


@pytest.mark.parametrize("field", [True, False])
def test_point_weight_image(field):
    """The point modes stream the camera's (field) and the shadow's
    (density) weight sequence: stream_fwd_weights(mats, field), its chunk
    count the library's (84 and 60), the kernel's arithmetic; the density's
    is the field's first 60 chunks (the trunk)."""
    mats = torch.arange(1, ff.MAT_ELEMENTS + 1, dtype=torch.float64)
    got = fr.stream_fwd_weights(mats, field)
    assert got.shape == ({True: 84, False: 60}[field], 8192)
    assert np.array_equal(got.numpy(), _stream_as_the_kernel(mats, field))
    assert torch.equal(fr.stream_fwd_weights(mats, True)[:60], fr.stream_fwd_weights(mats, False))
    assert ff.point_fwd_layout(field)["total"] >= got.shape[0] * 8192 * 2


@pytest.mark.parametrize("n", [1, 129, 300])
def test_cpu_point_forwards_stay_the_plain_versions(n):
    """On CPU tensors the wrappers return the plain versions' values and
    count no launch."""
    kw = _weights(seed=n)
    rng = np.random.default_rng(n)
    pos = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    emb = torch.from_numpy(rng.normal(size=(n, ff.EMB_DIM)).astype(np.float32))
    before = (ff.field_forward.launches, ff.density_forward.launches)
    got = ff.field_forward(kw, pos, emb)
    assert got.shape == (n, ff.FIELD_COLS)
    assert torch.equal(got, ff.field_forward_reference(kw, pos, emb))
    sigma = ff.density_forward(kw, pos)
    assert sigma.shape == (n,)
    assert torch.equal(sigma, ff.density_forward_reference(kw, pos))
    assert (ff.field_forward.launches, ff.density_forward.launches) == before
