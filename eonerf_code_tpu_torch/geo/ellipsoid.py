"""WGS84 ellipsoid transforms: geodetic (lat, lon, alt) <-> geocentric ECEF.

Semantics match the reference implementation (reference: sat_utils.py:61-97,
`latlon_to_ecef_custom` / `ecef_to_latlon_custom`): the inverse uses the
single-pass Bowring approximation, NOT an iterative solve — we reproduce that
exactly so ECEF-frame scene normalization round-trips bit-compatibly.

All functions take an ``xp`` array module (numpy by default). Angles in degrees,
lengths in meters.
"""

import numpy as np

# WGS84 constants
WGS84_A = 6378137.0
WGS84_FINV = 298.257223563
WGS84_F = 1.0 / WGS84_FINV
WGS84_E2 = 1.0 - (1.0 - WGS84_F) * (1.0 - WGS84_F)  # first eccentricity squared
# The reference's inverse uses this rounded eccentricity constant
# (sat_utils.py:84); keep it for parity of the Bowring pass.
_BOWRING_E = 8.1819190842622e-2


def latlon_to_ecef(lat, lon, alt, xp=np):
    """Geodetic -> ECEF. Reference: sat_utils.py:61-76."""
    rad_lat = lat * (xp.pi / 180.0)
    rad_lon = lon * (xp.pi / 180.0)
    sin_lat = xp.sin(rad_lat)
    v = WGS84_A / xp.sqrt(1.0 - WGS84_E2 * sin_lat * sin_lat)
    x = (v + alt) * xp.cos(rad_lat) * xp.cos(rad_lon)
    y = (v + alt) * xp.cos(rad_lat) * xp.sin(rad_lon)
    z = (v * (1.0 - WGS84_E2) + alt) * sin_lat
    return x, y, z


def ecef_to_latlon(x, y, z, xp=np):
    """ECEF -> geodetic via single-pass Bowring. Reference: sat_utils.py:78-97.

    Returns (lat, lon, alt) in degrees/meters. Accuracy is sufficient for the
    scene-normalization use case (sub-mm over the satellite altitude range).
    """
    a = WGS84_A
    e = _BOWRING_E
    asq = a**2
    esq = e**2
    b = xp.sqrt(asq * (1.0 - esq))
    bsq = b**2
    ep = xp.sqrt((asq - bsq) / bsq)
    p = xp.sqrt(x**2 + y**2)
    th = xp.arctan2(a * z, b * p)
    lon = xp.arctan2(y, x)
    lat = xp.arctan2(z + (ep**2) * b * (xp.sin(th) ** 3), p - esq * a * (xp.cos(th) ** 3))
    n = a / xp.sqrt(1.0 - esq * (xp.sin(lat) ** 2))
    alt = p / xp.cos(lat) - n
    lon = lon * 180.0 / xp.pi
    lat = lat * 180.0 / xp.pi
    return lat, lon, alt
