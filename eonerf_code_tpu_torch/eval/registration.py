"""DSM registration: multiscale NaN-aware normalized cross-correlation.

Functional port of the reference's numba-JIT'd `dsmr` module (dsmr.py): a
coarse-to-fine pyramid (2x NaN-aware downsampling until min dim < 100) with
an exhaustive +-5 px shift search per level maximizing masked NCC, then a
z-affine fit z -> a*z + b (a fixed to 1 when scaling=False, which is how the
MAE pipeline calls it — sat_utils.py:197).

Vectorized numpy (no per-pixel python loops): each of the 121 candidate
shifts is one masked reduction over the overlap region. Shift convention
matches the reference exactly: NCC compares u[j, i] against
v[j + dy, i + dx], and `apply_shift` resamples out[j, i] = a*v[j+dy, i+dx]+b.

A single-channel search takes the native C++/OpenMP library
(``native.ncc_search``, the same shifts; the reference's numba loops) unless
the caller passes ``use_native=False``; a library that does not build
raises.
"""

import numpy as np


def downsample2x(u):
    """NaN-aware 2x block-mean downsample of a (c, h, w) array (dsmr.py:16-46)."""
    c, h, w = u.shape
    ph, pw = (h + 1) // 2 * 2, (w + 1) // 2 * 2
    pad = np.full((c, ph, pw), np.nan, u.dtype)
    pad[:, :h, :w] = u
    blocks = pad.reshape(c, ph // 2, 2, pw // 2, 2)
    with np.errstate(invalid="ignore"):
        s = np.nansum(blocks, axis=(2, 4))
        n = np.sum(np.isfinite(blocks), axis=(2, 4))
        out = s / n
    out[n == 0] = np.nan
    return out


def _shifted_overlap(u, v, dx, dy):
    """Views of u[j,i] and v[j+dy,i+dx] over their valid overlap."""
    h, w = u.shape[-2], u.shape[-1]
    j0, j1 = max(0, -dy), min(h, v.shape[-2] - dy)
    i0, i1 = max(0, -dx), min(w, v.shape[-1] - dx)
    if j1 <= j0 or i1 <= i0:
        return None, None
    return u[0, j0:j1, i0:i1], v[0, j0 + dy:j1 + dy, i0 + dx:i1 + dx]


def masked_stats(u, v, dx=0, dy=0):
    """(mu_u, mu_v, sig_u, sig_v, xcorr) over jointly finite pixels
    (dsmr.py:50-88)."""
    uu, vv = _shifted_overlap(u, v, dx, dy)
    if uu is None:
        return 0.0, 0.0, 0.0, 0.0, 0.0
    m = np.isfinite(uu) & np.isfinite(vv)
    if not m.any():
        return 0.0, 0.0, 0.0, 0.0, 0.0
    a = uu[m].astype(np.float64)
    b = vv[m].astype(np.float64)
    muu, muv = a.mean(), b.mean()
    da, db = a - muu, b - muv
    return muu, muv, np.sqrt((da * da).mean()), np.sqrt((db * db).mean()), (da * db).mean()


def ncc(u, v, dx=0, dy=0):
    muu, muv, sigu, sigv, xcorr = masked_stats(u, v, dx, dy)
    denom = sigu * sigv
    return xcorr / denom if denom > 0 else -np.inf


def compute_ncc(u, v, irange, initdx, initdy, use_native=True):
    """Exhaustive search over (initdx, initdy) +- irange; the first maximum
    wins, scanning y-major then x (the reference tie-break order,
    dsmr.py:111-117). One channel (``u.shape[0] == 1``) goes to the native
    search unless ``use_native=False``; the numpy loop below otherwise."""
    if use_native and u.shape[0] == 1:
        from eonerf_code_tpu_torch import native

        return native.ncc_search(u[0], v[0], irange, initdx, initdy)
    best = (-np.inf, initdx, initdy)
    for y in range(initdy - irange, initdy + irange + 1):
        for x in range(initdx - irange, initdx + irange + 1):
            corr = ncc(u, v, x, y)
            if corr > best[0]:
                best = (corr, x, y)
    return best[1], best[2]


def recursive_ncc(u, v, irange=5, dx=0, dy=0):
    """Coarse-to-fine shift estimation (dsmr.py:120-135)."""
    if min(u.shape[-1], u.shape[-2]) > 100:
        dx, dy = recursive_ncc(downsample2x(u), downsample2x(v), irange, dx // 2, dy // 2)
        dx, dy = dx * 2, dy * 2
    return compute_ncc(u, v, irange, dx, dy)


def compute_shift_arrays(u, v, scaling=True):
    """(dx, dy, a, b) registering v onto u; arrays are (c, h, w) or (h, w)."""
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    if u.ndim == 2:
        u = u[None]
    if v.ndim == 2:
        v = v[None]
    dx, dy = recursive_ncc(u, v)
    muu, muv, sigu, sigv, _ = masked_stats(u, v, dx, dy)
    a = (sigu / sigv) if scaling else 1
    b = muu - muv * a
    return dx, dy, a, b


def apply_shift_arrays(v, dx=0, dy=0, a=1, b=0):
    """out[c, j, i] = a * v[c, j+dy, i+dx] + b, NaN outside (dsmr.py:138-149)."""
    v = np.asarray(v, np.float64)
    squeeze = v.ndim == 2
    if squeeze:
        v = v[None]
    _, h, w = v.shape
    out = np.full_like(v, np.nan)
    j0, j1 = max(0, -dy), min(h, h - dy)
    i0, i1 = max(0, -dx), min(w, w - dx)
    if j1 > j0 and i1 > i0:
        out[:, j0:j1, i0:i1] = a * v[:, j0 + dy:j1 + dy, i0 + dx:i1 + dx] + b
    return out[0] if squeeze else out


# ---- file interfaces (dsmr.py:152-215 signatures) ----

def compute_shift(dsm_ref_path, dsm_sec_path, scaling=True):
    from eonerf_code_tpu_torch.io.geotiff import read_geotiff

    return compute_shift_arrays(read_geotiff(dsm_ref_path), read_geotiff(dsm_sec_path),
                                scaling=scaling)


def apply_shift(in_dsm_path, out_dsm_path, dx=0, dy=0, a=1, b=0):
    from eonerf_code_tpu_torch.io.geotiff import GeoTiffFile, write_geotiff

    f = GeoTiffFile(in_dsm_path)
    out = apply_shift_arrays(f.read(), dx, dy, a, b).astype(np.float32)
    write_geotiff(out_dsm_path, out, profile=f.profile)
