"""The dgrad kernel's persistent-grid plan (ops/fused_render.py
``dgrad_plan`` and ``dgrad_block_tiles``, the mirror of
csrc/fused_render.cu's ``rays_per_block`` and ``dgrad_grid``) on the shapes
the port's backwards give it, and the phase bench's pieces that need no
card. No JAX and no card; the whole file runs in about a second."""

import re

import pytest

from eonerf_code_tpu_torch.bench import backward_passes as bp
from eonerf_code_tpu_torch.ops import _build
from eonerf_code_tpu_torch.ops import fused_render as fr

SMS = 132   # an H100 SXM

# KPAD -> rays a unit: whole rays filling 128-row tiles exactly, or one
# tile's worth past 1280 samples
UNITS = [(1, 128), (8, 16), (24, 16), (64, 2), (96, 4), (128, 1), (144, 8), (200, 1),
         (1024, 1)]


@pytest.mark.parametrize("kpad,rpb", UNITS)
def test_rays_per_unit(kpad, rpb):
    assert fr.rays_per_unit(kpad) == rpb
    assert rpb * kpad % 128 == 0 or rpb * kpad <= 128 or kpad >= 128


# (rays or points, KPAD) -> (rays a unit, units, blocks) on 132 SMs: the
# main path's training batch (camera K=127, hierarchical 143, shadow 63),
# the per-point backwards (1024 x 127 and 1024 x 63 points), the card tests'
# ragged shapes and a call smaller than the card
PLANS = [
    ((1024, 128), (1, 1024, 132)),
    ((1024, 144), (8, 128, 128)),
    ((1024, 64), (2, 512, 132)),
    ((1024 * 127, 1), (128, 1016, 132)),
    ((1024 * 63, 1), (128, 504, 132)),
    ((4093, 8), (16, 256, 132)),
    ((701, 96), (4, 176, 132)),
    ((2045, 144), (8, 256, 132)),
    ((37, 24), (16, 3, 3)),
]


@pytest.mark.parametrize("call,plan", PLANS)
def test_dgrad_plan_on_the_calls_shapes(call, plan):
    assert fr.dgrad_plan(*call, SMS) == plan


@pytest.mark.parametrize("call", [c for c, _ in PLANS])
def test_dgrad_blocks_cover_every_tile_once(call):
    """The blocks' tiles partition the call's rows: every unit's rows in
    128-row tiles, each exactly once, a block's units in ascending order and
    congruent to the block's index; the blocks' tile counts differ by no
    more than one unit's tiles; and the phase bench's tile count agrees."""
    r, kpad = call
    rpb, units, blocks = fr.dgrad_plan(r, kpad, SMS)
    per_block = fr.dgrad_block_tiles(r, kpad, SMS)
    assert len(per_block) == blocks
    seen = [t for tiles in per_block for t in tiles]
    assert len(seen) == len(set(seen))
    rows = {}
    for u, s0, n in seen:
        assert 0 < n <= 128 and s0 % 128 == 0
        rows[u] = rows.get(u, 0) + n
    assert rows == {u: min(rpb, r - u * rpb) * kpad for u in range(units)}
    for b, tiles in enumerate(per_block):
        us = [u for u, _, _ in tiles]
        assert us == sorted(us) and all(u % blocks == b for u in us)
    counts = [len(t) for t in per_block]
    assert max(counts) - min(counts) <= -(-rpb * kpad // 128)
    if kpad > 1:
        assert bp.dgrad_tiles(r, kpad) == len(seen)


def test_phase_names_follow_the_kernels_enum():
    """The phase bench's names (PHASES) are the kernel's DgPhase order, and
    every landmark the kernel marks is defined empty in the production
    source."""
    text = _build.SOURCE.read_text()
    enum = re.search(r"enum DgPhase \{([^}]*)\}", text).group(1)
    names = [n.strip()[3:].lower() for n in enum.split(",") if n.strip()]
    assert names == ["heads_in", "head_loops", "mask", "stores", "colsums", "pe_bwd",
                     "ray_sums", "other", "epilogue", "barrier"]
    assert [p.split("_")[0] for p in bp.PHASES[:10]] == [n.split("_")[0] for n in names]
    for macro in ("DG_MARK(next)", "DG_BEGIN()", "DG_TILE()", "DG_PRO()", "DG_MM()",
                  "DG_NEXT_CALL()", "DG_END(dst)"):
        assert f"#define {macro}\n" in text


def test_phase_source_of_this_tree_only_adds_the_prelude(tmp_path, monkeypatch):
    """This tree's source has its own landmarks: the instrumented copy is
    the prelude and the source unchanged (no substitution)."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    copy = bp.phase_source()
    text = _build.SOURCE.read_text()
    assert copy.read_text() == bp.PHASE_PRELUDE + text
    assert (copy.parent / "tile_common.cuh").read_text() == (
        _build.SOURCE.parent / "tile_common.cuh").read_text()
