"""UTM (Universal Transverse Mercator) projection, implemented from scratch.

The reference delegates lat/lon <-> UTM to pyproj/PROJ (reference:
sat_utils.py:99-131) and ships a low-order differentiable inverse for
bundle adjustment (sat_utils.py:365-418). Here both directions use the
exact-series Karney/Krüger transverse Mercator expansion to 6th order in
n = f/(2+f), which agrees with PROJ to sub-millimeter over the UTM domain,
for host-side float64 dataset construction.

Zone-number / zone-letter conventions follow the `utm` pypi package that the
reference relies on (including the Norway/Svalbard exceptions), so cached
`scene.loc_utm` files are interchangeable.
"""

import numpy as np

K0 = 0.9996
E0 = 500000.0
N0_SOUTH = 10000000.0

_F = 1.0 / 298.257223563
_A = 6378137.0
_N = _F / (2.0 - _F)

# Meridian arc scale: A = a/(1+n) (1 + n^2/4 + n^4/64 + n^6/256)
_ARC_A = _A / (1.0 + _N) * (1.0 + _N**2 / 4.0 + _N**4 / 64.0 + _N**6 / 256.0)

_n = _N
# Forward series coefficients (alpha_j), Karney 2011 eq. 12 / Krüger series.
_ALPHA = (
    _n / 2 - 2 * _n**2 / 3 + 5 * _n**3 / 16 + 41 * _n**4 / 180 - 127 * _n**5 / 288 + 7891 * _n**6 / 37800,
    13 * _n**2 / 48 - 3 * _n**3 / 5 + 557 * _n**4 / 1440 + 281 * _n**5 / 630 - 1983433 * _n**6 / 1935360,
    61 * _n**3 / 240 - 103 * _n**4 / 140 + 15061 * _n**5 / 26880 + 167603 * _n**6 / 181440,
    49561 * _n**4 / 161280 - 179 * _n**5 / 168 + 6601661 * _n**6 / 7257600,
    34729 * _n**5 / 80640 - 3418889 * _n**6 / 1995840,
    212378941 * _n**6 / 319334400,
)
# Inverse series coefficients (beta_j).
_BETA = (
    _n / 2 - 2 * _n**2 / 3 + 37 * _n**3 / 96 - _n**4 / 360 - 81 * _n**5 / 512 + 96199 * _n**6 / 604800,
    _n**2 / 48 + _n**3 / 15 - 437 * _n**4 / 1440 + 46 * _n**5 / 105 - 1118711 * _n**6 / 3870720,
    17 * _n**3 / 480 - 37 * _n**4 / 840 - 209 * _n**5 / 4480 + 5569 * _n**6 / 90720,
    4397 * _n**4 / 161280 - 11 * _n**5 / 504 - 830251 * _n**6 / 7257600,
    4583 * _n**5 / 161280 - 108847 * _n**6 / 3991680,
    20648693 * _n**6 / 638668800,
)
# Conformal-latitude -> geodetic-latitude series coefficients (delta_j).
_DELTA = (
    2 * _n - 2 * _n**2 / 3 - 2 * _n**3 + 116 * _n**4 / 45 + 26 * _n**5 / 45 - 2854 * _n**6 / 675,
    7 * _n**2 / 3 - 8 * _n**3 / 5 - 227 * _n**4 / 45 + 2704 * _n**5 / 315 + 2323 * _n**6 / 945,
    56 * _n**3 / 15 - 136 * _n**4 / 35 - 1262 * _n**5 / 105 + 73814 * _n**6 / 2835,
    4279 * _n**4 / 630 - 332 * _n**5 / 35 - 399572 * _n**6 / 14175,
    4174 * _n**5 / 315 - 144838 * _n**6 / 6237,
    601676 * _n**6 / 22275,
)

_E_SQRT = 2.0 * np.sqrt(_N) / (1.0 + _N)


def latlon_to_zone_number(lat, lon):
    """UTM zone number, with the Norway/Svalbard exceptions (matches the
    `utm` pypi package the reference calls at sat_utils.py:107)."""
    if 56.0 <= lat < 64.0 and 3.0 <= lon < 12.0:
        return 32
    if 72.0 <= lat <= 84.0 and lon >= 0.0:
        if lon < 9.0:
            return 31
        if lon < 21.0:
            return 33
        if lon < 33.0:
            return 35
        if lon < 42.0:
            return 37
    return int((lon + 180.0) / 6.0) + 1


def latitude_to_zone_letter(lat):
    letters = "CDEFGHJKLMNPQRSTUVWXX"
    if -80.0 <= lat <= 84.0:
        return letters[int(lat + 80.0) >> 3]
    return None


def utm_zonestring_from_lonlat(lon, lat):
    """Reference: sat_utils.py:127-131."""
    return "{}{}".format(latlon_to_zone_number(lat, lon), latitude_to_zone_letter(lat))


def central_meridian_deg(zone):
    return float((zone - 1) * 6 - 180 + 3)


def tm_forward(lat_deg, lon_deg, lon0_deg, xp=np):
    """Transverse Mercator forward: geodetic -> (easting-from-CM, northing).

    Returns raw TM coordinates before false easting/northing, scaled by k0.
    """
    phi = lat_deg * (xp.pi / 180.0)
    lam = (lon_deg - lon0_deg) * (xp.pi / 180.0)

    sin_phi = xp.sin(phi)
    t = xp.sinh(xp.arctanh(sin_phi) - _E_SQRT * xp.arctanh(_E_SQRT * sin_phi))
    xi = xp.arctan2(t, xp.cos(lam))
    eta = xp.arctanh(xp.sin(lam) / xp.sqrt(1.0 + t * t))

    x = eta
    y = xi
    for j, a in enumerate(_ALPHA, start=1):
        x = x + a * xp.cos(2 * j * xi) * xp.sinh(2 * j * eta)
        y = y + a * xp.sin(2 * j * xi) * xp.cosh(2 * j * eta)
    return K0 * _ARC_A * x, K0 * _ARC_A * y


def tm_inverse(x, y, lon0_deg, xp=np):
    """Transverse Mercator inverse: (easting-from-CM, northing) -> geodetic."""
    xi = y / (K0 * _ARC_A)
    eta = x / (K0 * _ARC_A)

    xi_p = xi
    eta_p = eta
    for j, b in enumerate(_BETA, start=1):
        xi_p = xi_p - b * xp.sin(2 * j * xi) * xp.cosh(2 * j * eta)
        eta_p = eta_p - b * xp.cos(2 * j * xi) * xp.sinh(2 * j * eta)

    chi = xp.arcsin(xp.sin(xi_p) / xp.cosh(eta_p))
    phi = chi
    for j, d in enumerate(_DELTA, start=1):
        phi = phi + d * xp.sin(2 * j * chi)
    lam = xp.arctan2(xp.sinh(eta_p), xp.cos(xi_p))
    lat = phi * (180.0 / xp.pi)
    lon = lon0_deg + lam * (180.0 / xp.pi)
    return lat, lon


def utm_from_latlon(lats, lons, zone=None, south=None, xp=np):
    """lat/lon -> UTM (easting, northing).

    Matches reference sat_utils.py:99-116: the zone is chosen from the FIRST
    point, and a false northing of 1e7 is applied for southern-hemisphere
    zone letters. Pass ``zone``/``south`` explicitly for the jittable path.
    """
    if zone is None:
        lat0 = float(np.asarray(lats).ravel()[0])
        lon0 = float(np.asarray(lons).ravel()[0])
        zone = latlon_to_zone_number(lat0, lon0)
        if south is None:
            south = latitude_to_zone_letter(lat0) < "N"
    x, y = tm_forward(lats, lons, central_meridian_deg(zone), xp=xp)
    easts = x + E0
    norths = y + (N0_SOUTH if south else 0.0)
    return easts, norths


def lonlat_from_utm(easts, norths, zonestring, xp=np):
    """UTM -> lon/lat. ``zonestring`` like '17R' or '21F' or plain '17'.

    Reference sat_utils.py:118-125 builds '+proj=utm +zone=<zonestring>'
    WITHOUT +south (PROJ parses the leading integer and ignores the letter),
    so the inverse always assumes a northern false northing of 0. We
    reproduce that exactly; the dataset code compensates for southern
    hemispheres by adding 1e7 to negative norths before rasterization
    (reference: datasets/satellite.py:560).
    """
    zone = int("".join(ch for ch in str(zonestring) if ch.isdigit()))
    x = easts - E0
    y = norths
    lat, lon = tm_inverse(x, y, central_meridian_deg(zone), xp=xp)
    return lon, lat
