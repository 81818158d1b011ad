"""Geodesy core: WGS84 ellipsoid, UTM projection, RPC camera models.

Everything here is implemented from scratch (no pyproj/rpcm/utm
dependency) in float64 numpy, for dataset construction at cm-level
parity. The formulas take an array-module parameter ``xp``.
"""

from eonerf_code_tpu_torch.geo.ellipsoid import (
    latlon_to_ecef,
    ecef_to_latlon,
)
from eonerf_code_tpu_torch.geo.utm import (
    utm_from_latlon,
    lonlat_from_utm,
    latlon_to_zone_number,
    latitude_to_zone_letter,
    utm_zonestring_from_lonlat,
    tm_forward,
    tm_inverse,
)
from eonerf_code_tpu_torch.geo.rpc import RPCModel, apply_poly, apply_rfm

__all__ = [
    "latlon_to_ecef",
    "ecef_to_latlon",
    "utm_from_latlon",
    "lonlat_from_utm",
    "latlon_to_zone_number",
    "latitude_to_zone_letter",
    "utm_zonestring_from_lonlat",
    "tm_forward",
    "tm_inverse",
    "RPCModel",
    "apply_poly",
    "apply_rfm",
]
