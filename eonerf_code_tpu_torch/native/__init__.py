"""ctypes bindings of the native C++/OpenMP host library
(``csrc/geo_native.cpp``): batch RPC localization and projection, the
NaN-aware NCC shift search and 2x downsample.

``ops/_build.py`` compiles it with g++ on first use, with the JAX build's
flags, into the hashed, atomically written ``_build/geo_native-<hash>.so``
beside the CUDA libraries; a concurrent build in another process or thread
never loads half a file.

A deliberate departure from the JAX package: nothing here falls back. The
JAX module returns None when its build fails, and its callers then take the
numpy path without a word. Here a failed build raises RuntimeError with
g++'s output, from every entry point. The numpy paths run only when the
caller asks for them: ``RPCModel.localization(..., use_native=False)`` and
``eval.registration.compute_ncc(..., use_native=False)``. The library needs
no CUDA: it builds and runs on the CPU test machine too.
"""

import ctypes
import functools

import numpy as np

from eonerf_code_tpu_torch.ops import _build


class _RpcCoeffs(ctypes.Structure):
    _fields_ = [
        ("row_offset", ctypes.c_double), ("col_offset", ctypes.c_double),
        ("lat_offset", ctypes.c_double), ("lon_offset", ctypes.c_double),
        ("alt_offset", ctypes.c_double),
        ("row_scale", ctypes.c_double), ("col_scale", ctypes.c_double),
        ("lat_scale", ctypes.c_double), ("lon_scale", ctypes.c_double),
        ("alt_scale", ctypes.c_double),
        ("row_num", ctypes.c_double * 20), ("row_den", ctypes.c_double * 20),
        ("col_num", ctypes.c_double * 20), ("col_den", ctypes.c_double * 20),
    ]


def build():
    """Compile the library unless an up-to-date one exists: (path, g++'s
    log). Raises RuntimeError when g++ fails or is missing."""
    return _build.build(_build.NATIVE_SOURCE)


@functools.cache
def load_library():
    """Build (if needed) and load the library with every entry point's
    argument types declared. A failed build raises (and is not cached: the
    next call tries again)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.rpc_localize_batch.argtypes = [ctypes.POINTER(_RpcCoeffs), dp, dp, dp,
                                       ctypes.c_int64, ctypes.c_int, dp, dp]
    lib.rpc_project_batch.argtypes = [ctypes.POINTER(_RpcCoeffs), dp, dp, dp,
                                      ctypes.c_int64, dp, dp]
    lib.ncc_search.argtypes = [dp, dp, ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int, ip, ip]
    lib.downsample2x.argtypes = [dp, ctypes.c_int64, ctypes.c_int64, dp]
    for name in ("rpc_localize_batch", "rpc_project_batch", "ncc_search", "downsample2x"):
        getattr(lib, name).restype = None
    return lib


def available():
    """Whether the library builds and loads here (a query: the entry points
    themselves raise when it does not)."""
    try:
        load_library()
    except RuntimeError:
        return False
    return True


def _coeffs_struct(rpc):
    c = _RpcCoeffs()
    for k in ("row_offset", "col_offset", "lat_offset", "lon_offset", "alt_offset",
              "row_scale", "col_scale", "lat_scale", "lon_scale", "alt_scale"):
        setattr(c, k, float(getattr(rpc, k)))
    for k in ("row_num", "row_den", "col_num", "col_den"):
        getattr(c, k)[:] = [float(v) for v in getattr(rpc, k)]
    return c


def _as_f64(x):
    return np.ascontiguousarray(np.asarray(x, np.float64))


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def rpc_localize(rpc, cols, rows, alts, iters=15):
    """Batch Newton localization of flat (col, row, alt) arrays through
    ``rpc`` (an RPCModel): (lons, lats), float64."""
    lib = load_library()
    cols, rows, alts = _as_f64(cols), _as_f64(rows), _as_f64(alts)
    n = cols.size
    lons = np.empty(n, np.float64)
    lats = np.empty(n, np.float64)
    c = _coeffs_struct(rpc)
    lib.rpc_localize_batch(ctypes.byref(c), _ptr(cols), _ptr(rows), _ptr(alts),
                           n, iters, _ptr(lons), _ptr(lats))
    return lons, lats


def rpc_project(rpc, lons, lats, alts):
    """Batch projection of flat (lon, lat, alt) arrays: (cols, rows)."""
    lib = load_library()
    lons, lats, alts = _as_f64(lons), _as_f64(lats), _as_f64(alts)
    n = lons.size
    cols = np.empty(n, np.float64)
    rows = np.empty(n, np.float64)
    c = _coeffs_struct(rpc)
    lib.rpc_project_batch(ctypes.byref(c), _ptr(lons), _ptr(lats), _ptr(alts),
                          n, _ptr(cols), _ptr(rows))
    return cols, rows


def ncc_search(u, v, irange=5, initdx=0, initdy=0):
    """Exhaustive NCC shift search on (h, w) float64 arrays: (dx, dy) of the
    first maximum, scanning y-major then x."""
    lib = load_library()
    u, v = _as_f64(u), _as_f64(v)
    if u.ndim != 2 or v.shape != u.shape:
        raise ValueError(f"ncc_search takes two (h, w) arrays of one shape, got {u.shape} "
                         f"and {v.shape}")
    dx = ctypes.c_int(0)
    dy = ctypes.c_int(0)
    lib.ncc_search(_ptr(u), _ptr(v), u.shape[0], u.shape[1],
                   int(irange), int(initdx), int(initdy),
                   ctypes.byref(dx), ctypes.byref(dy))
    return dx.value, dy.value


def downsample2x(u):
    """NaN-aware 2x block mean of an (h, w) array."""
    lib = load_library()
    u = _as_f64(u)
    oh, ow = (u.shape[0] + 1) // 2, (u.shape[1] + 1) // 2
    out = np.empty((oh, ow), np.float64)
    lib.downsample2x(_ptr(u), u.shape[0], u.shape[1], _ptr(out))
    return out
