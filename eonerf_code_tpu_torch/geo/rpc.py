"""RPC (Rational Polynomial Coefficient) camera model, from scratch.

The reference uses the `rpcm` package for RPC projection/localization
(reference: datasets/satellite.py:54,436; sat_utils.py:268-270) and ships a
torch copy of the 20-term cubic polynomial for a never-wired bundle
adjustment (sat_utils.py:420-450). Here the model is a self-contained,
vectorized, array-module-generic implementation:

- ``project``: ground (lon, lat, alt) -> image (col, row). Direct polynomial
  ratio evaluation.
- ``localize``: image (col, row) + alt -> ground (lon, lat). This is the
  *inverse* problem; rpcm solves it with an iterative finite-difference
  scheme. We use a fixed-iteration Newton solve with the ANALYTIC Jacobian
  of the cubic, which is jit-compilable (static iteration count) and
  converges quadratically: a fixed-iteration, vectorised batch op.

All functions accept an array module ``xp`` (numpy by default); dataset
construction runs them in float64 numpy. ``RPCModel.localization`` hands
batches of 4096 points or more to the native C++/OpenMP solve
(``native.rpc_localize``, the same bits), as the JAX package does.
"""

import copy as _copy

import numpy as np

# Polynomial term ordering follows the RPB/rpcm convention, where the three
# normalized variables are (y=lon_n, x=lat_n, z=alt_n):
#   out = p0 + p1*y + p2*x + p3*z + p4*y*x + p5*y*z + p6*x*z
#       + p7*y^2 + p8*x^2 + p9*z^2 + p10*x*y*z + p11*y^3 + p12*y*x^2
#       + p13*y*z^2 + p14*y^2*x + p15*x^3 + p16*x*z^2 + p17*y^2*z
#       + p18*x^2*z + p19*z^3
# (reference template: sat_utils.py:437-450)


def apply_poly(poly, x, y, z):
    """Evaluate the 20-term cubic RPC polynomial. x=lat_n, y=lon_n, z=alt_n."""
    out = 0
    out += poly[0]
    out += poly[1] * y + poly[2] * x + poly[3] * z
    out += poly[4] * y * x + poly[5] * y * z + poly[6] * x * z
    out += poly[7] * y * y + poly[8] * x * x + poly[9] * z * z
    out += poly[10] * x * y * z
    out += poly[11] * y * y * y
    out += poly[12] * y * x * x + poly[13] * y * z * z + poly[14] * y * y * x
    out += poly[15] * x * x * x
    out += poly[16] * x * z * z + poly[17] * y * y * z + poly[18] * x * x * z
    out += poly[19] * z * z * z
    return out


def apply_poly_grad(poly, x, y, z):
    """Analytic (d/dx, d/dy) of `apply_poly` — used by the Newton inverse."""
    dx = (
        poly[2]
        + poly[4] * y
        + poly[6] * z
        + 2 * poly[8] * x
        + poly[10] * y * z
        + 2 * poly[12] * y * x
        + poly[14] * y * y
        + 3 * poly[15] * x * x
        + poly[16] * z * z
        + 2 * poly[18] * x * z
    )
    dy = (
        poly[1]
        + poly[4] * x
        + poly[5] * z
        + 2 * poly[7] * y
        + poly[10] * x * z
        + 3 * poly[11] * y * y
        + poly[12] * x * x
        + poly[13] * z * z
        + 2 * poly[14] * y * x
        + 2 * poly[17] * y * z
    )
    return dx, dy


def apply_rfm(num, den, x, y, z):
    """Rational function: poly ratio."""
    return apply_poly(num, x, y, z) / apply_poly(den, x, y, z)


def apply_rfm_grad(num, den, x, y, z):
    """Analytic (d/dx, d/dy) of the rational function num/den."""
    n = apply_poly(num, x, y, z)
    d = apply_poly(den, x, y, z)
    nx, ny = apply_poly_grad(num, x, y, z)
    dx, dy = apply_poly_grad(den, x, y, z)
    inv_d2 = 1.0 / (d * d)
    return (nx * d - n * dx) * inv_d2, (ny * d - n * dy) * inv_d2


def project(coeffs, lon, lat, alt, xp=np):
    """Ground -> image. Returns (col, row).

    ``coeffs`` is a dict of arrays (see RPCModel.coeffs).
    """
    nlon = (lon - coeffs["lon_offset"]) / coeffs["lon_scale"]
    nlat = (lat - coeffs["lat_offset"]) / coeffs["lat_scale"]
    nalt = (alt - coeffs["alt_offset"]) / coeffs["alt_scale"]
    col = apply_rfm(coeffs["col_num"], coeffs["col_den"], nlat, nlon, nalt)
    row = apply_rfm(coeffs["row_num"], coeffs["row_den"], nlat, nlon, nalt)
    col = col * coeffs["col_scale"] + coeffs["col_offset"]
    row = row * coeffs["row_scale"] + coeffs["row_offset"]
    return col, row


def localize(coeffs, col, row, alt, xp=np, iters=15):
    """Image + altitude -> ground. Returns (lon, lat).

    Fixed-iteration Newton on the normalized 2x2 system.
    """
    ncol = (col - coeffs["col_offset"]) / coeffs["col_scale"]
    nrow = (row - coeffs["row_offset"]) / coeffs["row_scale"]
    nalt = (alt - coeffs["alt_offset"]) / coeffs["alt_scale"]

    # unknowns: x = nlat, y = nlon, initialized at the offset center
    x = xp.zeros_like(ncol)
    y = xp.zeros_like(ncol)
    cnum, cden = coeffs["col_num"], coeffs["col_den"]
    rnum, rden = coeffs["row_num"], coeffs["row_den"]
    for _ in range(iters):
        fc = apply_rfm(cnum, cden, x, y, nalt) - ncol
        fr = apply_rfm(rnum, rden, x, y, nalt) - nrow
        jcx, jcy = apply_rfm_grad(cnum, cden, x, y, nalt)
        jrx, jry = apply_rfm_grad(rnum, rden, x, y, nalt)
        det = jcx * jry - jcy * jrx
        inv_det = 1.0 / det
        x = x - inv_det * (jry * fc - jcy * fr)
        y = y - inv_det * (-jrx * fc + jcx * fr)

    lat = x * coeffs["lat_scale"] + coeffs["lat_offset"]
    lon = y * coeffs["lon_scale"] + coeffs["lon_offset"]
    return lon, lat


class RPCModel:
    """RPC camera with rpcm-compatible construction and API.

    Accepts the `rpcm` dict format used by the DFC2019/IARPA json metadata
    (keys: {row,col,lat,lon,alt}_{offset,scale}, {row,col}_{num,den}).
    """

    _SCALAR_KEYS = (
        "row_offset", "col_offset", "lat_offset", "lon_offset", "alt_offset",
        "row_scale", "col_scale", "lat_scale", "lon_scale", "alt_scale",
    )
    _POLY_KEYS = ("row_num", "row_den", "col_num", "col_den")

    def __init__(self, d):
        for k in self._SCALAR_KEYS:
            setattr(self, k, float(d[k]))
        for k in self._POLY_KEYS:
            v = np.asarray([float(c) for c in d[k]], dtype=np.float64)
            if v.shape != (20,):
                raise ValueError(f"RPC poly '{k}' must have 20 coefficients, got {v.shape}")
            setattr(self, k, v)

    def to_dict(self):
        d = {k: getattr(self, k) for k in self._SCALAR_KEYS}
        d.update({k: getattr(self, k).tolist() for k in self._POLY_KEYS})
        return d

    def coeffs(self, xp=np, dtype=None):
        """Dict of coefficients for the functional project/localize API."""
        out = {}
        for k in self._SCALAR_KEYS:
            out[k] = xp.asarray(getattr(self, k), dtype=dtype) if dtype else getattr(self, k)
        for k in self._POLY_KEYS:
            out[k] = xp.asarray(getattr(self, k), dtype=dtype)
        return out

    def projection(self, lon, lat, alt):
        """(lon, lat, alt) -> (col, row), rpcm-compatible signature."""
        return project(self.coeffs(), np.asarray(lon, dtype=np.float64),
                       np.asarray(lat, dtype=np.float64), np.asarray(alt, dtype=np.float64))

    def localization(self, col, row, alt, use_native=True):
        """(col, row, alt) -> (lon, lat), rpcm-compatible signature.

        From 4096 points on, the native C++/OpenMP batch solve
        (``native.rpc_localize``: large pixel grids, where the reference
        spends minutes per scene in rpcm's python loop); below that, or with
        ``use_native=False``, the vectorised float64 Newton solve of
        :func:`localize`, which gives the same bits. A native library that
        does not build raises: nothing falls back to numpy.
        """
        col = np.asarray(col, dtype=np.float64)
        row = np.asarray(row, dtype=np.float64)
        alt = np.asarray(alt, dtype=np.float64)
        if use_native and col.size >= 4096:
            from eonerf_code_tpu_torch import native

            col, row, alt = np.broadcast_arrays(col, row, alt)
            lons, lats = native.rpc_localize(self, col.ravel(), row.ravel(), alt.ravel())
            return lons.reshape(col.shape), lats.reshape(col.shape)
        return localize(self.coeffs(), col, row, alt)

    def incidence_angles(self, lon, lat, z=0.0):
        """(view zenith angle deg, view azimuth deg) at a ground point.

        Used to pick the most-nadir view for the DSM sweep (reference:
        sat_utils.py:262-272, eval_eonerf.py:285). Computed by localizing the
        pixel at two altitudes and measuring the ray's tilt from vertical in
        a local ENU frame.
        """
        dz = 100.0
        col, row = self.projection(lon, lat, z)
        lon1, lat1 = self.localization(col, row, z)
        lon2, lat2 = self.localization(col, row, z + dz)
        # meters per degree in the local frame
        m_per_deg_lat = 111320.0
        m_per_deg_lon = 111320.0 * np.cos(np.radians(lat1))
        de = (lon2 - lon1) * m_per_deg_lon
        dn = (lat2 - lat1) * m_per_deg_lat
        zenith = np.degrees(np.arctan2(np.hypot(de, dn), dz))
        azimuth = np.degrees(np.arctan2(de, dn)) % 360.0
        return float(np.asarray(zenith).ravel()[0]), float(np.asarray(azimuth).ravel()[0])

    def rescaled(self, alpha):
        """Return a copy scaled for an image resize by factor ``alpha``
        (reference: sat_utils.py:41-59). alpha = 1/downscale."""
        r = _copy.deepcopy(self)
        r.row_scale *= float(alpha)
        r.col_scale *= float(alpha)
        r.row_offset *= float(alpha)
        r.col_offset *= float(alpha)
        return r
