"""Reproject a georeferenced DSM into a satellite image's pixel grid.

Port of the reference's depth-prior generator (sat_utils.py:310-362): sample
the DSM at 2x supersampling, convert the UTM grid to lon/lat in-process (the
reference uses a pyproj Transformer), project through the RPC, and paint the
altitudes (or any co-registered value raster) into the image grid.
"""

import numpy as np

from eonerf_code_tpu_torch.geo import lonlat_from_utm
from eonerf_code_tpu_torch.geo.utm import N0_SOUTH
from eonerf_code_tpu_torch.io.geotiff import GeoTiffFile


def crs_to_lonlat(crs, easts, norths):
    """UTM CRS -> lon/lat, honoring the southern false northing."""
    zone, south = crs.utm_zone()
    if zone is None:
        raise ValueError(f"unsupported CRS for reprojection: {crs}")
    n = norths - N0_SOUTH if south else norths
    lons, lats = lonlat_from_utm(easts, n, str(zone))
    return lons, lats


def reproject_dsm_to_image(dsm_path, out_h, out_w, rpc, other_val_path=None,
                           pt_density=2):
    """Returns an (out_h, out_w) float32 raster of reprojected values
    (NaN where nothing lands)."""
    src = GeoTiffFile(dsm_path)
    dsm = src.read(1).ravel()
    b = src.bounds
    h, w = src.height, src.width

    xs = np.linspace(b.left, b.right, w * pt_density)
    ys = np.linspace(b.top, b.bottom, h * pt_density)
    X, Y = np.meshgrid(xs, ys)
    easts, norths = X.ravel(), Y.ravel()
    cgrid, rgrid = np.meshgrid(np.linspace(0, w - 1, w * pt_density),
                               np.linspace(0, h - 1, h * pt_density))
    index1d = (rgrid.astype(int).ravel() * w + cgrid.astype(int).ravel())
    alts = dsm[index1d].astype(np.float64)

    lons, lats = crs_to_lonlat(src.crs, easts, norths)
    cols, rows = rpc.projection(lons, lats, np.nan_to_num(alts, nan=0.0))

    valid = (cols >= 0) & (cols < out_w) & (rows >= 0) & (rows < out_h) & np.isfinite(alts)
    cols, rows = cols[valid], rows[valid]

    if other_val_path is None:
        vals = alts[valid]
    else:
        other = GeoTiffFile(other_val_path)
        assert other.width == w and other.height == h
        vals = other.read(1).ravel()[index1d][valid].astype(np.float64)

    out = np.full((out_h, out_w), np.nan, np.float32)
    out[rows.astype(np.int32), cols.astype(np.int32)] = vals
    return out
