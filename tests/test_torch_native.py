"""The port's native host library (eonerf_code_tpu_torch/native,
csrc/geo_native.cpp) against the port's numpy paths at the JAX package's
pins (tests/test_native.py), against the JAX package's native and numpy
functions on the same seeded inputs, the dispatch of
RPCModel.localization and compute_ncc, a failed build raising, and two
processes building into one empty directory at once."""

import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from numpy.lib.stride_tricks import sliding_window_view

from eonerf_code_tpu import native as jax_native
from eonerf_code_tpu.eval import registration as jax_reg
from eonerf_code_tpu.geo import rpc as jax_rpc
from eonerf_code_tpu_torch import native
from eonerf_code_tpu_torch.eval import registration as reg
from eonerf_code_tpu_torch.geo import rpc as rpc_mod
from eonerf_code_tpu_torch.ops import _build
from tests.test_geo import make_synthetic_rpc

REPO = pathlib.Path(__file__).resolve().parent.parent


def _rpcs():
    """(the port's RPCModel, the JAX package's) of one synthetic camera."""
    jax_model = make_synthetic_rpc(0.05)
    return rpc_mod.RPCModel(jax_model.to_dict()), jax_model


def _localize_inputs(rng, n=5000):
    return rng.uniform(0, 1000, n), rng.uniform(0, 1000, n), rng.uniform(-30, 120, n)


def _ncc_pair(rng, nans):
    """A smooth field and a shifted copy (tests/test_native.py's two cases),
    or ("ties") a field periodic in x against itself, which scores within
    rounding of 1 at every even dx (tests/test_torch_eval_host.py's tie)."""
    if nans == "ties":
        rows = np.random.default_rng(3).standard_normal(24)
        u = rows[:, None] * (-1.0) ** np.arange(24)[None, :]
        return u, u
    if nans:
        u = rng.standard_normal((80, 80))
        u[10:20, 10:20] = np.nan
        return u, np.roll(u, (2, -3), axis=(0, 1))
    sm = sliding_window_view(rng.standard_normal((140, 140)), (9, 9)).mean(axis=(2, 3))
    return sm[4:104, 4:104], sm[1:101, 7:107]


@pytest.fixture
def jax_lib(monkeypatch):
    """The JAX package's native module, loaded. Its thread-locked build can
    lose a race between pytest workers and then reports itself unavailable
    for good (ROADMAP Queue 3); by now the library is on disk, so a worker
    that lost it tries the load once more."""
    if not jax_native.available():
        monkeypatch.setattr(jax_native, "_tried", False)
    assert jax_native.available(), "the JAX package's native library does not load"
    return jax_native


# ---- the port's native against the port's numpy paths, at the JAX pins ----

def test_localize_matches_numpy(rng):
    rpc, _ = _rpcs()
    cols, rows, alts = _localize_inputs(rng)
    lon_py, lat_py = rpc_mod.localize(rpc.coeffs(), cols, rows, alts)
    lon_c, lat_c = native.rpc_localize(rpc, cols, rows, alts)
    np.testing.assert_allclose(lon_c, lon_py, rtol=0, atol=1e-14)
    np.testing.assert_allclose(lat_c, lat_py, rtol=0, atol=1e-14)


def test_project_matches_numpy(rng):
    rpc, _ = _rpcs()
    lons = rng.uniform(-81.70, -81.62, 3000)
    lats = rng.uniform(30.31, 30.39, 3000)
    alts = rng.uniform(-30, 120, 3000)
    col_py, row_py = rpc_mod.project(rpc.coeffs(), lons, lats, alts)
    col_c, row_c = native.rpc_project(rpc, lons, lats, alts)
    np.testing.assert_allclose(col_c, col_py, rtol=0, atol=1e-10)
    np.testing.assert_allclose(row_c, row_py, rtol=0, atol=1e-10)


@pytest.mark.parametrize("nans", [False, True, "ties"])
def test_ncc_search_matches_numpy(rng, nans):
    """The same shift as the numpy search: each score is the numpy path's
    arithmetic, so near-ties order alike."""
    u, v = _ncc_pair(rng, nans)
    numpy_shift = reg.compute_ncc(u[None], v[None], 5, 0, 0, use_native=False)
    assert native.ncc_search(u, v, 5, 0, 0) == numpy_shift
    assert reg.compute_ncc(u[None], v[None], 5, 0, 0) == numpy_shift


def test_downsample_matches_numpy(rng):
    u = rng.standard_normal((31, 45))
    u[3, 4] = np.nan
    np.testing.assert_allclose(native.downsample2x(u), reg.downsample2x(u[None])[0],
                               atol=1e-12, equal_nan=True)


# ---- against the JAX package's native and numpy functions ----

def test_localize_and_project_match_jax(rng, jax_lib):
    """The port's library sums each polynomial in the numpy path's
    association: the JAX numpy path's bits. The JAX library sums left to
    right and lies within the JAX pins of both. (Its NCC scores, one-pass
    moments, can order exact ties otherwise: the shifts are held against
    it on the untied pairs only.)"""
    rpc, jax_model = _rpcs()
    cols, rows, alts = _localize_inputs(rng)
    got = native.rpc_localize(rpc, cols, rows, alts)
    jax_c = jax_lib.rpc_localize(jax_model, cols, rows, alts)
    jax_py = jax_rpc.localize(jax_model.coeffs(), cols, rows, alts)
    for g, c, p in zip(got, jax_c, jax_py):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_allclose(g, c, rtol=0, atol=1e-14)
    lons, lats = got
    got_p = native.rpc_project(rpc, lons, lats, alts)
    jax_pc = jax_lib.rpc_project(jax_model, lons, lats, alts)
    jax_pp = jax_rpc.project(jax_model.coeffs(), lons, lats, alts)
    for g, c, p in zip(got_p, jax_pc, jax_pp):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_allclose(g, c, rtol=0, atol=1e-10)


@pytest.mark.parametrize("nans", [False, True])
def test_ncc_and_downsample_match_jax(rng, jax_lib, nans):
    u, v = _ncc_pair(rng, nans)
    shift = native.ncc_search(u, v, 5, 1, -1)
    assert shift == jax_lib.ncc_search(u, v, 5, 1, -1)
    assert shift == jax_reg.compute_ncc(u[None], v[None], 5, 1, -1, use_native=False)
    np.testing.assert_array_equal(native.downsample2x(u), jax_lib.downsample2x(u))


# ---- dispatch ----

@pytest.mark.parametrize("n, native_calls", [(4095, 0), (4096, 1)])
def test_localization_dispatch_threshold(rng, monkeypatch, n, native_calls):
    """4095 points take the numpy solve, 4096 the native one (the JAX
    package's threshold); both give the numpy path's lon/lat."""
    rpc, _ = _rpcs()
    calls = []
    real = native.rpc_localize
    monkeypatch.setattr(native, "rpc_localize",
                        lambda *a, **k: calls.append(a[1].size) or real(*a, **k))
    cols, rows, alts = _localize_inputs(rng, n)
    got = rpc.localization(cols.reshape(-1, 1), rows.reshape(-1, 1), alts.reshape(-1, 1))
    assert len(calls) == native_calls
    want = rpc.localization(cols.reshape(-1, 1), rows.reshape(-1, 1), alts.reshape(-1, 1),
                            use_native=False)
    assert len(calls) == native_calls
    for g, w in zip(got, want):
        assert g.shape == (n, 1)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-14)


def test_ncc_dispatch(rng, monkeypatch):
    """One channel takes the native search, several channels or
    use_native=False the numpy loop."""
    calls = []
    real = native.ncc_search
    monkeypatch.setattr(native, "ncc_search", lambda *a: calls.append(1) or real(*a))
    u, v = _ncc_pair(rng, False)
    one = reg.compute_ncc(u[None], v[None], 3, 0, 0)
    assert len(calls) == 1
    assert reg.compute_ncc(u[None], v[None], 3, 0, 0, use_native=False) == one
    assert reg.compute_ncc(np.stack([u, u]), np.stack([v, v]), 3, 0, 0) == one
    assert len(calls) == 1


# ---- a failed build raises ----

@pytest.mark.parametrize("fault", ["missing_compiler", "bad_source"])
def test_failed_build_raises(rng, monkeypatch, tmp_path, fault):
    """No fallback: with g++ missing, or a source g++ refuses, every entry
    point and the dispatching callers raise RuntimeError with the
    compiler's words, and nothing is left in the build directory."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    if fault == "missing_compiler":
        monkeypatch.setattr(_build, "gxx_path", lambda: str(tmp_path / "no-such-g++"))
        words = "could not run"
    else:
        bad = tmp_path / "geo_native.cpp"
        bad.write_text("extern \"C\" void rpc_localize_batch( {\n")
        monkeypatch.setattr(_build, "NATIVE_SOURCE", bad)
        words = "error"
    native.load_library.cache_clear()
    try:
        rpc, _ = _rpcs()
        cols, rows, alts = _localize_inputs(rng, 4096)
        with pytest.raises(RuntimeError, match=words):
            rpc.localization(cols, rows, alts)
        with pytest.raises(RuntimeError, match=words):
            native.ncc_search(np.zeros((8, 8)), np.zeros((8, 8)))
        with pytest.raises(RuntimeError, match=words):
            reg.compute_ncc(np.zeros((1, 8, 8)), np.zeros((1, 8, 8)), 1, 0, 0)
        assert not native.available()
        # the numpy paths still run when asked for
        rpc.localization(cols, rows, alts, use_native=False)
        assert not any((tmp_path / "_build").glob("*"))
    finally:
        native.load_library.cache_clear()


# ---- two processes build into one empty directory at once ----

_BUILDER = textwrap.dedent("""
    import pathlib, sys, time
    import numpy as np
    from eonerf_code_tpu_torch import native
    from eonerf_code_tpu_torch.geo import rpc as rpc_mod
    from eonerf_code_tpu_torch.ops import _build
    _build.BUILD_DIR = pathlib.Path(sys.argv[1])
    go = pathlib.Path(sys.argv[2])
    while not go.exists():
        time.sleep(0.005)
    path, log = native.build()
    num_c, num_r, den = np.zeros(20), np.zeros(20), np.zeros(20)
    num_c[1], num_c[3], num_c[7] = 1.0, 0.15, 0.05
    num_r[2], num_r[3], num_r[8] = -1.0, 0.08, 0.05
    den[0], den[9] = 1.0, 0.01
    rpc = rpc_mod.RPCModel({**{k: 1.0 for k in rpc_mod.RPCModel._SCALAR_KEYS},
                            "col_num": num_c, "row_num": num_r, "col_den": den, "row_den": den})
    x = np.linspace(-0.5, 0.5, 4096)
    lon, lat = rpc.localization(x, x[::-1], np.zeros_like(x))
    ref = rpc.localization(x, x[::-1], np.zeros_like(x), use_native=False)
    print(path.name, float(np.abs(lon - ref[0]).max()), float(np.abs(lat - ref[1]).max()))
""")


def test_concurrent_builds_load_a_whole_library(tmp_path):
    build_dir, go = tmp_path / "_build", tmp_path / "go"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, str(build_dir), str(go)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    go.touch()       # both processes are waiting: they start the build together
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = [out.split() for out, _ in outs]
    assert lines[0][0] == lines[1][0]
    for _, lon_err, lat_err in lines:
        assert float(lon_err) <= 1e-14 and float(lat_err) <= 1e-14
    assert [p.name for p in build_dir.iterdir()] == [lines[0][0]]   # no temporary left
