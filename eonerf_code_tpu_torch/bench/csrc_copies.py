"""Copies of csrc/ for measurement, shared by the benches that time a design
variant, a cost taken out, or clock64 phases against the source as it is:
how a copy is made (exact substitutions, a prelude), how a production
source's phase landmarks are defined in a copy, how copies are built (every
nvcc started together), and how builds are timed in turns. The copies live
under _build/copies/ (git-ignored; the build hashes them by content).
"""

import concurrent.futures
import contextlib
import re
import shutil
from pathlib import Path

from eonerf_code_tpu_torch.ops import _build


def source_copy(tag, subs=(), prelude="", source=None, flags=0):
    """The csrc/ that holds ``source`` (by default this tree's
    fused_render.cu) copied under _build/copies/<tag>, each substitution of
    ``subs`` made exactly once (a (pattern, replacement) pair applies to
    fused_render.cu, a (file, pattern, replacement) triple to that file of
    the copy; the pattern a regular expression under ``flags``, the
    replacement literal text), then ``prelude`` put in front of
    fused_render.cu: the copy's fused_render.cu."""
    src = Path(source or _build.SOURCE)
    dst = _build.BUILD_DIR / "copies" / tag
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src.parent, dst)
    files = {}
    for sub in subs:
        name, pattern, repl = sub if len(sub) == 3 else (src.name, *sub)
        text = files.get(name, (dst / name).read_text())
        files[name], n = re.subn(pattern, lambda _, repl=repl: repl, text, flags=flags)
        if n != 1:
            raise RuntimeError(f"{name} matches {pattern!r} {n} times, not once")
    files[src.name] = prelude + files.get(src.name, (dst / src.name).read_text())
    for name, text in files.items():
        (dst / name).write_text(text)
    return dst / src.name


def phase_prelude(origin, phases):
    """C macros defining, in a copy, the phase landmarks that the production
    source leaves empty: for each prefix P of ``phases`` (P -> its phase
    names), P_BEGIN() at a kernel's start, P_MARK(next) where the current
    phase ends and phase ``next`` (an index) starts, P_END(dst) at its end.
    Thread 0 of a block adds the clock64() cycles of each phase up in a
    local array (not in shared memory: a static shared array would move the
    dynamic shared memory off the alignment swizzled tiles need) and P_END
    writes the totals, as floats, to dst[0 .. n-1]. ``origin`` names the
    bench in the copy's first line."""
    out = [f"// phase instrumentation ({origin}; this copy only)",
           "#define PH_MARK(arr, n, next) do { if (threadIdx.x == 0) { "
           "const long long t_ = clock64(); \\",
           "    arr[arr[n + 1]] += t_ - arr[n]; arr[n] = t_; arr[n + 1] = (next); } } while (0)",
           "#define PH_BEGIN(arr, n) long long arr[n + 2]; do { for (int k_ = 0; k_ < n; ++k_) \\",
           "    arr[k_] = 0; arr[n] = clock64(); arr[n + 1] = 0; } while (0)",
           "#define PH_END(arr, n, dst) do { PH_MARK(arr, n, 0); __syncthreads(); "
           "if (threadIdx.x == 0) \\",
           "    for (int k_ = 0; k_ < n; ++k_) (dst)[k_] = (float)arr[k_]; } while (0)"]
    for prefix, names in phases.items():
        arr, n = f"{prefix.lower()}_ph", len(names)
        out += [f"#define {prefix}_MARK(next) PH_MARK({arr}, {n}, next)",
                f"#define {prefix}_BEGIN() PH_BEGIN({arr}, {n})",
                f"#define {prefix}_END(dst) PH_END({arr}, {n}, dst)"]
    return "\n".join(out) + "\n"


def build_all(sources):
    """Build every source, each nvcc started together: the build logs."""
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        return [log for _, log in pool.map(_build.build, sources)]


@contextlib.contextmanager
def using(source):
    """The port's library from ``source`` (a copy's fused_render.cu) inside
    the block, this tree's again after it."""
    default = _build.SOURCE
    try:
        _build.SOURCE = Path(source)
        _build.load_library.cache_clear()
        yield
    finally:
        _build.SOURCE = default
        _build.load_library.cache_clear()


def in_turns(builds, turn):
    """{tag: [turn(tag), ...]}: ``turn`` run on each build of ``builds``
    ({tag: fused_render.cu}) in order, then in reverse (so that each build
    is timed before and after the others)."""
    out = {tag: [] for tag in builds}
    for tag in list(builds) + list(builds)[::-1]:
        with using(builds[tag]):
            out[tag].append(turn(tag))
    return out
