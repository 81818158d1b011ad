"""Bundle-adjustment export: learned ray-bundle offsets -> RPC corrections
(the JAX package's geo/bundle_adjust.py).

The field learns per-image translations of the ray bundle in the
normalized scene frame (``EONerfField.ray_correction_enc``, the reference's
--rpc_correction). The image-space equivalent of one such translation:

  1. denormalize the offset into UTM metres,
  2. take a reference ground point with and without the offset to lon/lat
     through the inverse UTM,
  3. project both through the RPC; the displacement is the col/row offset
     to subtract from the RPC.

Satellite ray bundles are near-parallel, so one constant image-space shift
carries the bundle translation across the scene (the EO-NeRF paper's
assumption).
"""

import numpy as np

from eonerf_code_tpu_torch.geo.utm import N0_SOUTH, lonlat_from_utm


def rpc_offset_from_scene_offset(rpc, scene_offset_n, scene_scale, scene_origin, utm_zonestring,
                                 south=False, alt=0.0):
    """(d_col, d_row): the image-space shift of a normalized-frame bundle
    translation ``scene_offset_n`` (3,) of the image with ``rpc``, for the
    scene normalization ``scene_scale`` (per axis) and ``scene_origin``
    (UTM offset of the cube centre), evaluated at altitude ``alt`` metres.
    A corrected RPC uses col_offset - d_col, row_offset - d_row."""
    d_world = np.asarray(scene_offset_n, np.float64) * np.asarray(scene_scale, np.float64)
    base = np.asarray(scene_origin, np.float64).copy()
    base[2] = alt
    shifted = base + d_world

    def project(pt):
        n = pt[1] - (N0_SOUTH if south else 0.0)
        lon, lat = lonlat_from_utm(np.array([pt[0]]), np.array([n]), utm_zonestring)
        col, row = rpc.projection(lon, lat, np.array([pt[2]]))
        return float(col[0]), float(row[0])

    c0, r0 = project(base)
    c1, r1 = project(shifted)
    return c1 - c0, r1 - r0


def corrected_rpc(rpc, scene_offset_n, scene_scale, scene_origin, utm_zonestring, south=False,
                  alt=0.0):
    """A copy of ``rpc`` with the learned bundle correction folded into its
    col/row offsets."""
    d_col, d_row = rpc_offset_from_scene_offset(rpc, scene_offset_n, scene_scale, scene_origin,
                                                utm_zonestring, south=south, alt=alt)
    out = rpc.rescaled(1.0)   # a deep copy
    out.col_offset -= d_col
    out.row_offset -= d_row
    return out
