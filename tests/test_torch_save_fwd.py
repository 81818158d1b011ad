"""The save forwards' streamed design without a card (csrc/fused_render.cu
stream_fwd_kernel's save mode): the plan that ops/fused_render.py mirrors
(``save_fwd_plan``: every sample row a row, whole rays a block of the
persistent grid, b R / G rays before block b), the store map (``save_fwd_
stores``: each trunk layer's tile columns copied to its stream columns),
the workspace's layout (``save_fwd_layout``) and the CPU wrappers, which
stay the plain versions. No JAX and no card; the whole file runs in a few
seconds."""

import numpy as np
import pytest
import torch

from eonerf_code_tpu_torch.ops import fused_field as ff
from eonerf_code_tpu_torch.ops import fused_render as fr
from tests.test_torch_fwd_plan import _weights

# the main path's training batches (camera KPAD 128 and the hierarchical
# 144, shadow 64) and ragged ray counts
MAIN_SHAPES = [(1024, 128), (1024, 144), (1024, 64)]
RAGGED = [(r, kpad) for r in (1, 127, 1021) for kpad in (128, 144, 64)]


def _first_rays_as_the_kernel(r, blocks):
    """sv_first_ray of every block and of the grid's end, one at a time in
    the kernel's integer arithmetic."""
    return [b * r // blocks for b in range(blocks + 1)]


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("r,kpad", MAIN_SHAPES + RAGGED)
def test_save_plan_covers_every_row_once(sms, r, kpad):
    """Every stream row ray * KPAD + k (padding included) is owned by
    exactly one block; a block owns whole rays, its rows one contiguous
    range in ray order; the blocks' rows differ by at most KPAD; each block
    has at least one ray; its tiles are its rows in 128-row pieces."""
    plan = fr.save_fwd_plan(r, kpad, sms)
    blocks, first = plan["blocks"], plan["first_ray"].numpy()
    assert blocks == min(sms, ff.STREAM_MAX_BLOCKS, r)
    assert first.tolist() == _first_rays_as_the_kernel(r, blocks)
    assert first[0] == 0 and first[-1] == r
    rays = np.diff(first)
    assert rays.min() >= 1
    owner_of_ray = np.repeat(np.arange(blocks), rays)
    assert len(owner_of_ray) == r
    # rows: row g belongs to ray g // kpad, so to that ray's block
    owner = np.repeat(np.arange(blocks), plan["rows"].numpy())
    assert len(owner) == r * kpad and np.array_equal(owner, np.sort(owner))
    assert np.array_equal(owner, owner_of_ray[np.arange(r * kpad) // kpad])
    rows = plan["rows"].numpy()
    assert np.array_equal(rows, rays * kpad)
    assert rows.max() - rows.min() <= kpad
    assert np.array_equal(plan["tiles"].numpy(), -(-rows // 128))


@pytest.mark.parametrize("r,kpad,tiles", [(1024, 128, 8), (1024, 144, 9), (1024, 64, 4)])
def test_save_plan_tiles_on_the_main_path(r, kpad, tiles):
    """On an H100's 132 SMs a block takes at most 8 camera tiles at KPAD
    128 (a ray a tile), 9 at 144 (rays straddle tiles) and 4 shadow tiles
    at 64 (two rays a tile): the least that whole tiles of the call's rows
    allow, ceil(tiles / 132)."""
    plan = fr.save_fwd_plan(r, kpad, 132)
    assert int(plan["tiles"].max()) == tiles == -(-(r * kpad // 128) // 132)
    # every tile lies in one block; at 144 some tiles hold two rays' rows
    first_row = plan["first_ray"] * kpad
    starts = torch.cat([torch.arange(int(first_row[b]), int(first_row[b + 1]), 128)
                        for b in range(plan["blocks"])])
    assert len(starts) == int(plan["tiles"].sum())
    ends = torch.minimum(starts + 127, torch.repeat_interleave(first_row[1:] - 1,
                                                               plan["tiles"]))
    straddle = (starts // kpad) != (ends // kpad)
    assert bool(straddle.any()) == (kpad != 128)


def test_save_plan_edges():
    """No ray: no block (the wrappers return before the launch); fewer
    rays than SMs: a ray a block; the largest grid."""
    plan = fr.save_fwd_plan(0, 128, 132)
    assert plan["blocks"] == 0 and plan["first_ray"].tolist() == [0]
    plan = fr.save_fwd_plan(5, 64, 132)
    assert plan["blocks"] == 5 and plan["first_ray"].tolist() == [0, 1, 2, 3, 4, 5]
    plan = fr.save_fwd_plan(5000, 8, 4096)
    assert plan["blocks"] == ff.STREAM_MAX_BLOCKS


def test_store_map_tiles_the_stream_columns_once():
    """The copies cover stream columns 0..2111 (h0..h4, the PE, h5..h7)
    exactly once, each from the tile columns that hold it when the copy is
    issued (h_i in 0..255 after layer i, the PE in 256..319 until layer 5),
    and never the camera's head columns 2112..3071."""
    stores = fr.save_fwd_stores()
    assert [s[0] for s in stores] == list(range(8))
    hits = np.zeros(fr.PLAIN_STREAM_COLS[True], np.int64)
    for i, c0, n, d0 in stores:
        assert c0 == 0 and d0 == fr._act_col(i)
        assert n == (256 + ff.PE_PAD if i == 4 else 256)   # the PE only once, after h4
        hits[d0:d0 + n] += 1
    assert (hits[:fr.PLAIN_STREAM_COLS[False]] == 1).all() and not hits[2112:].any()
    # the PE's stream columns are where the backward reads it: [h4 | PE] at
    # layer 5's input
    assert fr._act_col(4) + 256 == 5 * 256 and fr._act_col(5) == 5 * 256 + ff.PE_PAD


@pytest.mark.parametrize("camera", [True, False])
def test_store_map_gives_stream_trunk_acts(monkeypatch, camera):
    """The store map applied to a tile whose columns hold each layer's
    output in turn gives, through stream_trunk_acts (the plain version's
    saved layout), h0..h7 in order, the PE in its columns, and leaves the
    camera's head columns as they were."""
    monkeypatch.setattr(fr, "act_stream_cols", lambda c: fr.PLAIN_STREAM_COLS[bool(c)])
    r, k, kpad = 3, 5, 8
    rows = r * kpad
    rng = np.random.default_rng(1)
    h = [torch.from_numpy(rng.normal(size=(rows, 256)).astype(np.float32)) for _ in range(8)]
    pe = torch.from_numpy(rng.normal(size=(rows, ff.PE_PAD)).astype(np.float32))
    stream = torch.full((rows, fr.PLAIN_STREAM_COLS[camera]), float("nan"))
    tile = torch.zeros((rows, 328))
    tile[:, 256:320] = pe
    for i, c0, n, d0 in fr.save_fwd_stores():
        tile[:, 0:256] = h[i]           # layer i's epilogue, in place
        if i == 5:
            tile[:, 256:320] = 0.0      # layer 5 read the PE last; later copies must not
        stream[:, d0:d0 + n] = tile[:, c0:c0 + n]
    got = fr.stream_trunk_acts(stream, camera, r, k)
    want = torch.cat(h, dim=1).view(r, kpad, -1)[:, :k].reshape(r * k, -1)
    assert torch.equal(got, want)
    assert torch.equal(stream[:, fr._act_col(4) + 256:fr._act_col(5)], pe)
    assert bool(torch.isnan(stream[:, 2112:]).all())


@pytest.mark.parametrize("camera", [True, False])
def test_save_workspace_layout(camera):
    """Each part 256-byte aligned; the weight image first, the size of the
    point modes' (the same heads); every row's results after it."""
    for r, kpad in MAIN_SHAPES + [(1, 8), (7, 1000)]:
        lay = fr.save_fwd_layout(camera, r, kpad)
        offs = [lay["stream"], lay["res"], lay["total"]]
        assert all(o % 256 == 0 for o in offs) and offs == sorted(offs)
        assert lay["res"] == ff.point_fwd_layout(camera)["total"]
        assert lay["total"] - lay["res"] >= r * kpad * (8 if camera else 1) * 4


@pytest.mark.parametrize("r", [0, 3])
def test_cpu_save_forwards_stay_the_plain_versions(r):
    """On CPU tensors the save wrappers return the plain save versions'
    values and count no launch."""
    kw = _weights()
    rng = np.random.default_rng(r)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    rayin = t(np.hstack([rng.uniform(-0.5, 0.5, (r, 3)), np.tile([0.0, 0.0, -1.0], (r, 1)),
                         rng.normal(size=(r, 4)), np.zeros((r, 6))]))
    z = t(np.sort(rng.uniform(0.0, 2.0, (r, 13)), axis=1))
    dm = t(rng.uniform(0.0, 0.1, (r, 13)))
    mask = t(np.ones((r, 13)))
    before = (fr.camera_forward_save.launches, fr.shadow_forward_save.launches)
    for got, want in ((fr.camera_forward_save(kw, rayin, z, dm),
                       fr.camera_forward_reference(kw, rayin, z, dm, save=True)),
                      (fr.shadow_forward_save(kw, rayin, z, dm, mask),
                       fr.shadow_forward_reference(kw, rayin, z, dm, mask, save=True))):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (fr.camera_forward_save.launches, fr.shadow_forward_save.launches) == before
