"""Device-side DSM evaluation: rasterisation in the local frame, masked NCC
registration over a fixed 2x pyramid, z-bias fit, clip and masked MAE, on
the tensors' device; and the linear ECEF -> UTM frame that puts an ECEF
cube's points on the GT grid.

Semantics of the JAX package's eval/device.py (and of its host
eval/registration.py): the same pyramid rule (halve while the smaller side
is > 100), an exhaustive +-irange search per level scanning y-major with
the first maximum winning, scaling off. Grids are in LOCAL scene
coordinates (UTM minus the scene offset), where float32 resolves ~1e-5 m.
"""

import numpy as np
import torch
import torch.nn.functional as F

from eonerf_code_tpu_torch.ops.raster import rasterize_pointcloud


def _masked_downsample2x(img, mask):
    """NaN-free 2x block mean with a validity mask. (H, W) -> (H//2, W//2)."""
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    img = img[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2)
    mask = mask[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2)
    s = torch.where(mask, img, 0.0).sum(dim=(1, 3))
    n = mask.sum(dim=(1, 3))
    return torch.where(n > 0, s / n.clamp(min=1), 0.0), n > 0


def _ncc_at_shift(u, um, v, vm, dx, dy):
    """Masked NCC of u[j, i] vs v[j+dy, i+dx] (the registration convention);
    v is pre-padded and dx, dy index into the padded array."""
    h, w = u.shape
    vv = v[dy:dy + h, dx:dx + w]
    m = um & vm[dy:dy + h, dx:dx + w]
    cnt = m.sum()
    n = cnt.clamp(min=1)
    mu = torch.where(m, u, 0.0).sum() / n
    mv = torch.where(m, vv, 0.0).sum() / n
    du = torch.where(m, u - mu, 0.0)
    dv = torch.where(m, vv - mv, 0.0)
    denom = torch.sqrt((du * du).sum() / n) * torch.sqrt((dv * dv).sum() / n)
    xc = (du * dv).sum() / n
    return torch.where((denom > 0) & (cnt > 0), xc / denom, float("-inf"))


def _search_level(u, um, v, vm, init_dx, init_dy, irange, pad):
    """Exhaustive +-irange search around (init_dx, init_dy); returns the
    best (dx, dy) as ints, the first maximum in y-major order winning."""
    vp = F.pad(v, (pad, pad, pad, pad))
    vpm = F.pad(vm, (pad, pad, pad, pad))
    offs = range(-irange, irange + 1)
    scores = torch.stack([_ncc_at_shift(u, um, vp, vpm, pad + init_dx + dx, pad + init_dy + dy)
                          for dy in offs for dx in offs])
    best = int(torch.argmax(scores))   # torch.argmax returns the FIRST maximum
    span = 2 * irange + 1
    return init_dx + best % span - irange, init_dy + best // span - irange


def device_dsm_mae(pred_dsm, gt_dsm, irange=5, n_levels=None, clip_slack=10.0):
    """Registered mean |altitude error| of pred vs gt height grids (H, W)
    on the same grid, NaN for empty cells. Returns (mae, (dx, dy, bias)):
    mae and bias 0-d float32 tensors on the grids' device, dx and dy ints.
    Convention: pred[j+dy, i+dx] aligns with gt[j, i]."""
    pred = pred_dsm.float()
    gt = gt_dsm.float()
    pm = torch.isfinite(pred)
    gm = torch.isfinite(gt)
    pred = torch.where(pm, pred, 0.0)
    gt = torch.where(gm, gt, 0.0)

    if n_levels is None:       # fixed pyramid: halve while min dim > 100 (dsmr.py:120-135)
        n_levels = 0
        m = min(gt.shape)
        while m > 100:
            n_levels += 1
            m //= 2
    levels = [(gt, gm, pred, pm)]
    for _ in range(n_levels):
        g, gmk, p, pmk = levels[-1]
        levels.append((*_masked_downsample2x(g, gmk), *_masked_downsample2x(p, pmk)))

    # coarsest -> finest: search, then double the shift into the next level
    dx = dy = 0
    max_shift = irange * (2 ** (n_levels + 1))
    for li in range(len(levels) - 1, -1, -1):
        g, gmk, p, pmk = levels[li]
        dx, dy = _search_level(g, gmk, p, pmk, dx, dy, irange, pad=max_shift + irange + 2)
        if li > 0:
            dx, dy = dx * 2, dy * 2

    # z bias (scaling off): mean(gt) - mean(pred at the shift)
    pad = max_shift + 32
    h, w = gt.shape
    vv = F.pad(pred, (pad, pad, pad, pad))[pad + dy:pad + dy + h, pad + dx:pad + dx + w]
    vvm = F.pad(pm, (pad, pad, pad, pad))[pad + dy:pad + dy + h, pad + dx:pad + dx + w]
    m = gm & vvm
    n = m.sum().clamp(min=1)
    bias = (torch.where(m, gt, 0.0).sum() - torch.where(m, vv, 0.0).sum()) / n
    gmax = torch.where(gm, gt, float("-inf")).max()
    gmin = torch.where(gm, gt, float("inf")).min()
    reg = torch.clamp(vv + bias, gmin - clip_slack, gmax + clip_slack)
    mae = torch.where(m, (reg - gt).abs(), 0.0).sum() / n
    return mae, (dx, dy, bias)


def rasterize_local(easts_l, norths_l, alts, xoff_l, yoff_l, resolution, xsize, ysize,
                    radius=1):
    """(ysize, xsize) DSM of points in the local frame (UTM minus the scene
    offset) on their device: ``ops/raster.py::rasterize_pointcloud``."""
    return rasterize_pointcloud(easts_l, norths_l, alts, xoff_l, yoff_l, resolution, xsize,
                                ysize, radius=radius)


def ecef_to_utm_frame(center_ecef, zone, south):
    """Local linear frame for an ECEF cube's device eval.

    Returns (J, (E0, N0, alt0)): J is the 3x3 Jacobian of the exact
    ecef -> (UTM easting, northing, altitude) chain at the scene center,
    by central differences through the host geodesy (float64), so it
    carries the true UTM point scale factor and grid convergence; an ENU
    basis alone would rotate the scene by the convergence angle.

    Cube deltas then map linearly: (E, N, alt) ~ (E0, N0, alt0) + J @ d_ecef.
    The residual is the projection's curvature over the scene, about
    extent^2 / (2 R_earth): under 2 mm at 200 m, about 8 cm at 1 km. The
    host path (eval/dsm.py) stays the exact reference.
    """
    from eonerf_code_tpu_torch.geo.ellipsoid import ecef_to_latlon
    from eonerf_code_tpu_torch.geo.utm import utm_from_latlon

    center = np.asarray(center_ecef, np.float64)

    def f(p):
        lat, lon, alt = ecef_to_latlon(p[0:1], p[1:2], p[2:3])
        e, n = utm_from_latlon(lat, lon, zone=zone, south=south)
        return np.array([float(e[0]), float(n[0]), float(alt[0])])

    origin = f(center)
    jac = np.zeros((3, 3))
    for i in range(3):
        dp = np.zeros(3)
        dp[i] = 1.0
        jac[:, i] = (f(center + dp) - f(center - dp)) / 2.0
    return jac, (origin[0], origin[1], origin[2])
