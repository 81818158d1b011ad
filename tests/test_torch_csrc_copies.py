"""The benches' copies of csrc/ (eonerf_code_tpu_torch/bench/csrc_copies.py):
every substitution the benches make into a copy matches this tree's
source exactly once, the phase prelude defines each landmark the source
leaves empty, and builds are timed in turns with this tree's library
restored after. Text only: no nvcc, no card, no JAX."""

import re

import pytest

from eonerf_code_tpu_torch.bench import backward_passes as bp
from eonerf_code_tpu_torch.bench import csrc_copies as cc
from eonerf_code_tpu_torch.bench import q8_backward as qb
from eonerf_code_tpu_torch.bench import q8_trunk as qt
from eonerf_code_tpu_torch.bench import stream_fwd as sf
from eonerf_code_tpu_torch.ops import _build

COPIES = {**{f"q8_backward.{tag}": subs for tag, subs in qb.ATTRIBUTION.items()},
          **{f"q8_trunk.{tag}": subs for tag, subs in qt.ATTRIBUTION.items()},
          **{f"backward_passes.{tag}": subs for tag, subs in bp.DGRAD_ATTRIBUTION.items()},
          "q8_trunk.phases": qt.PHASE_SUBS,
          # fused_fwd_kernel and gemm stay in this tree as in the design the
          # streamed forwards replaced, so its phase copy applies to both
          "stream_fwd.parent_phases": sf.PARENT_SUBS,
          **{f"stream_fwd.{tag}": subs for tag, subs in sf.ATTRIBUTION.items()},
          **{f"stream_fwd.{tag}": subs for tag, subs in sf.CONFIGS.items()}}


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    return tmp_path


@pytest.mark.parametrize("name", sorted(COPIES))
def test_every_bench_copy_applies_to_this_tree(build_dir, name):
    """Each attribution, phase or configuration copy's substitutions match
    this tree's fused_render.cu (or the header they name) once each (a copy
    that no longer applies raises before anything is built), and change
    it."""
    copy = cc.source_copy(name.replace(".", "_"), COPIES[name])
    assert copy.parent.parent == build_dir / "copies"
    src = _build.SOURCE.parent
    assert any((copy.parent / f.name).read_text() != f.read_text()
               for f in src.iterdir() if f.suffix in (".cu", ".cuh"))


def test_source_copy_refuses_a_pattern_not_matched_once(build_dir):
    with pytest.raises(RuntimeError, match="0 times"):
        cc.source_copy("missing", [(r"no such line in the source", "")])
    with pytest.raises(RuntimeError, match="times, not once"):
        cc.source_copy("twice", [(r"__global__", "")])


def test_q8_backward_phase_copy_defines_each_landmark(build_dir):
    """The production source defines the QC_* and QW_* landmarks empty; the
    phase copy is the prelude and the source unchanged, and the prelude
    defines each of them with its phase count."""
    text = _build.SOURCE.read_text()
    copy = cc.source_copy("q8_bwd_phases", prelude=qb.PHASE_PRELUDE)
    assert copy.read_text() == qb.PHASE_PRELUDE + text
    for prefix, names in (("QC", qb.CHAIN_PHASES), ("QW", qb.WGRAD_PHASES)):
        for macro in ("MARK(next)", "BEGIN()", "END(dst)"):
            assert f"#define {prefix}_{macro}\n" in text
            assert f"#define {prefix}_{macro} PH_" in qb.PHASE_PRELUDE
        assert f"PH_BEGIN({prefix.lower()}_ph, {len(names)})" in qb.PHASE_PRELUDE
        marks = {int(m) for m in re.findall(rf"{prefix}_MARK\((\d+)\);", text)}
        assert marks and max(marks) < len(names)


def test_partials_source_appends_to_this_tree():
    """The per-group partials design (bench/q8_wgrad_partials.cu) uses this
    tree's weight-gradient helpers, and its C entry is not in the
    production source."""
    text = _build.SOURCE.read_text()
    extra = qb.PARTIALS_SOURCE.read_text()
    for name in ("q8_wgrad_tile", "q8_in_of", "q8_g8_rows", "wgmma_s8_ss_m64n64", "q8_bwd_layout",
                 "q8_wgrad_tiles", "QW_T"):
        assert name in text and name in extra
    assert "eonerf_q8_wgrad_partials" in extra and "eonerf_q8_wgrad_partials" not in text


def test_in_turns_runs_in_order_then_back_and_restores_the_source(tmp_path):
    builds = {tag: tmp_path / tag / "fused_render.cu" for tag in ("a", "b", "c")}
    seen = []
    out = cc.in_turns(builds, lambda tag: seen.append((tag, _build.SOURCE)) or len(seen))
    assert [tag for tag, _ in seen] == ["a", "b", "c", "c", "b", "a"]
    assert all(src == builds[tag] for tag, src in seen)
    assert out == {"a": [1, 6], "b": [2, 5], "c": [3, 4]}
    default = _build.SOURCE
    with pytest.raises(ValueError):
        with cc.using(builds["a"]):
            raise ValueError
    assert _build.SOURCE == default


def test_stream_fwd_phase_copy_defines_each_landmark(build_dir):
    """The streamed forwards' FS_* landmarks are empty in the production
    source and defined by the copy's prelude, their phases bench/
    stream_fwd.py's PHASES in the order of the source's FsPhase; the
    earlier design's copy (PARENT_SUBS) gets the FW_* prelude and marks
    within its PARENT_PHASES."""
    text = _build.SOURCE.read_text()
    for macro in ("MARK(next)", "BEGIN()", "END()"):
        assert f"#define FS_{macro}\n" in text
    enum = re.search(r"enum FsPhase \{([^}]*)\}", text).group(1)
    assert [n.strip()[4:].lower() for n in enum.split(",")] == list(sf.PHASES)
    copy = sf.phase_source()
    prelude = cc.summed_phase_prelude("bench/stream_fwd.py", "FS", len(sf.PHASES))
    assert copy.read_text() == prelude + text
    for macro in ("MARK(next)", "BEGIN()", "END()", "CALL(base)", "NEXT_CALL()", "TILE()"):
        assert f"#define FS_{macro} " in prelude
    parent = cc.source_copy("fwd_phases_parent", sf.PARENT_SUBS,
                            cc.summed_phase_prelude("x", "FW", len(sf.PARENT_PHASES)))
    marks = [int(m) for m in re.findall(r"FW_(?:MARK|CALL)\((\d+)\)", parent.read_text())]
    # a camera tile's 14 gemm calls (the trunk's 8, the heads' 6) stay in range
    assert marks and max(marks) + 4 * 13 < len(sf.PARENT_PHASES)
