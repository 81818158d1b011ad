"""Synthetic multi-date satellite scene factory.

Generates a complete on-disk dataset in the exact format the satellite
pipeline consumes (per-image JSON metadata with an RPC dict + sun angles,
GeoTIFF images, train/test splits, lidar-style GT DSM + CLS rasters), so the
full train -> DSM -> registered-MAE loop can be exercised hermetically —
the environment has no DFC2019/IARPA data.

Scene model: a flat ground plane at altitude 0 with one box building, in UTM
coordinates near a configurable lat/lon. Cameras are *real RPCs*: for each
view an orthographic pushbroom-like projection (parallel rays along the view
direction) is sampled over a (lon, lat, alt) grid and fitted with the
20-term cubic RPC numerator by least squares — the same way production RPCs
are generated — so the dataset round-trips through the framework's actual
RPC localization path. Images are rendered analytically with the EO-NeRF
irradiance model (albedo * (s + (1-s) * 0.2 * ambient)), with geometric
shadows cast by the box, optional per-view radiometric perturbations
(rgb' = A*rgb + b), and optional transient patches.
"""

import dataclasses
import os

import numpy as np

from eonerf_code_tpu_torch.data.satellite import dir_vec_from_el_az, write_json
from eonerf_code_tpu_torch.geo import RPCModel, latlon_to_zone_number, latitude_to_zone_letter, utm_from_latlon
from eonerf_code_tpu_torch.geo.rpc import apply_poly
from eonerf_code_tpu_torch.io.geotiff import Affine, CRS, write_geotiff


@dataclasses.dataclass
class SyntheticSceneSpec:
    lat0: float = 30.35
    lon0: float = -81.66
    extent: float = 200.0        # scene side length, meters
    box_height: float = 20.0
    box_size: float = 70.0       # building footprint side, meters
    box_center: tuple = (20.0, -15.0)  # offset from scene center, meters
    n_buildings: int = 1         # >1: extra random boxes (seeded), heights
                                 # up to box_height, city-block style
    n_views: int = 8
    n_test_views: int = 2
    img_size: int = 96
    min_alt: float = -2.0
    max_alt: float = 32.0
    dsm_resolution: float = 2.0
    ambient_color: tuple = (0.25, 0.35, 0.55)  # sky light
    radiometric_jitter: float = 0.0  # std of per-view A/b perturbation
    rpc_bias_px: float = 0.0     # max |row/col| bias injected into each
                                 # TRAIN view's published RPC (the image is
                                 # rendered with the true camera) — simulates
                                 # real-world RPC miscalibration, the
                                 # condition bundle adjustment corrects
    seed: int = 0


class SyntheticScene:
    """Analytic geometry + shading for the box-on-plane scene."""

    def __init__(self, spec: SyntheticSceneSpec):
        self.spec = spec
        e0, n0 = utm_from_latlon(np.array([spec.lat0]), np.array([spec.lon0]))
        self.e0, self.n0 = float(e0[0]), float(n0[0])
        self.zone = latlon_to_zone_number(spec.lat0, spec.lon0)
        self.south = latitude_to_zone_letter(spec.lat0) < "N"

    def _buildings(self):
        """[(ce, cn, half_e, half_n, h)] — the primary box plus optional
        seeded extras placed on a jittered grid."""
        s = self.spec
        boxes = [(self.e0 + s.box_center[0], self.n0 + s.box_center[1],
                  s.box_size / 2, s.box_size / 2, s.box_height)]
        if s.n_buildings > 1:
            rng = np.random.default_rng(s.seed + 1234)
            k = int(np.ceil(np.sqrt(s.n_buildings - 1)))
            span = s.extent * 0.72
            cells = [(i, j) for i in range(k) for j in range(k)]
            rng.shuffle(cells)
            for i, j in cells[: s.n_buildings - 1]:
                ce = self.e0 - span / 2 + (i + 0.5) * span / k + rng.uniform(-5, 5)
                cn = self.n0 - span / 2 + (j + 0.5) * span / k + rng.uniform(-5, 5)
                he = rng.uniform(8, max(span / k / 2 - 6, 9))
                hn = rng.uniform(8, max(span / k / 2 - 6, 9))
                h = rng.uniform(0.3, 1.0) * s.box_height
                boxes.append((ce, cn, he, hn, h))
        return boxes

    def height(self, easts, norths):
        """GT heightfield h(e, n): max over the building boxes."""
        e = np.asarray(easts)
        n = np.asarray(norths)
        out = np.zeros(np.broadcast(e, n).shape)
        for ce, cn, he, hn, h in self._buildings():
            inside = (np.abs(e - ce) <= he) & (np.abs(n - cn) <= hn)
            out = np.maximum(out, np.where(inside, h, 0.0))
        return out

    def albedo(self, easts, norths):
        """(N, 3) surface albedo: checkerboard ground, gray roof, both
        modulated by a world-anchored multi-frequency texture.

        The texture is essential for the photometric geometry signal: with
        textureless surfaces the only parallax gradients come from edges and
        shadows, and a NeRF can park the roof at ground level almost
        penalty-free (real satellite imagery is richly textured)."""
        e = np.asarray(easts)
        n = np.asarray(norths)
        check = ((np.floor((e - self.e0) / 25.0) + np.floor((n - self.n0) / 25.0)) % 2)
        ground = np.stack([0.35 + 0.3 * check, 0.45 - 0.15 * check, 0.30 + 0.1 * check], -1)
        roof = np.broadcast_to(np.array([0.65, 0.6, 0.58]), ground.shape)
        on_roof = self.height(e, n) > 0
        base = np.where(on_roof[..., None], roof, ground)
        tex = (np.sin(2 * np.pi * (e - self.e0) / 13.7)
               + np.sin(2 * np.pi * (n - self.n0) / 17.3)
               + np.sin(2 * np.pi * (e + n - self.e0 - self.n0) / 8.9)
               + np.sin(2 * np.pi * (e - n - self.e0 + self.n0) / 23.1)) / 4.0
        return np.clip(base * (1.0 + 0.45 * tex[..., None]), 0.02, 1.0)

    def _box_entry_t(self, o, d, t_min=0.0):
        """Smallest positive entry t of each ray into any building box
        (exact AABB slab tests, vectorized over rays). Returns +inf where
        no box is hit."""
        best = np.full(o.shape[0], np.inf)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = np.where(np.abs(d) > 1e-12, 1.0 / d, np.inf)
            for ce, cn, he, hn, h in self._buildings():
                lo = np.array([ce - he, cn - hn, 0.0])
                hi = np.array([ce + he, cn + hn, h])
                t1 = (lo - o) * inv
                t2 = (hi - o) * inv
                tmin = np.minimum(t1, t2).max(axis=1)
                tmax = np.maximum(t1, t2).min(axis=1)
                entry = np.maximum(tmin, t_min)
                hit = (tmax >= entry) & (tmax > t_min)
                best = np.where(hit, np.minimum(best, entry), best)
        return best

    def march(self, o, d, fars, **_legacy):
        """Exact first-hit of each ray against the box-city + ground plane.

        (Named `march` for historical reasons — the implementation is an
        analytic AABB/plane intersection, not a sampler: exact and ~1000x
        faster than stepping.) o (N,3), d unit (N,3), fars (N,).
        Returns (t_hit, hit_xyz, any_hit)."""
        o = np.asarray(o, np.float64)
        d = np.asarray(d, np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            t_ground = np.where(d[:, 2] < -1e-12, -o[:, 2] / d[:, 2], np.inf)
        t_box = self._box_entry_t(o, d)
        t_hit = np.minimum(t_ground, t_box)
        any_hit = np.isfinite(t_hit)
        t_hit = np.where(any_hit, t_hit, fars)
        hit = o + d * t_hit[:, None]
        return t_hit, hit, any_hit

    def sun_visibility(self, pts, sun_dir_to_ground, eps=0.2, **_legacy):
        """1 where the sun is visible from pts, 0 in cast shadow.

        ``sun_dir_to_ground`` points from the sun toward the ground; the
        occlusion ray is its negation. Exact: occluded iff the ray toward
        the sun enters any building box (entry offset ``eps`` meters along
        the ray avoids self-intersection for points ON a wall/roof)."""
        d = -np.asarray(sun_dir_to_ground, np.float64)
        d = d / np.linalg.norm(d)
        o = np.asarray(pts, np.float64) + eps * d
        dirs = np.broadcast_to(d, o.shape)
        t_box = self._box_entry_t(o, dirs, t_min=1e-9)
        return np.where(np.isfinite(t_box), 0.0, 1.0)


def _orthographic_projection(scene, view_az_deg, view_el_deg, gsd, img_size):
    """Projection fn (lon, lat, alt) -> (col, row) for an orthographic camera
    looking along the view direction (el measured from nadir)."""
    v = dir_vec_from_el_az(view_el_deg, view_az_deg)  # from camera toward ground
    v = v / np.linalg.norm(v)

    def proj(lons, lats, alts):
        easts, norths = utm_from_latlon(np.asarray(lats, np.float64).ravel(),
                                        np.asarray(lons, np.float64).ravel(),
                                        zone=scene.zone, south=scene.south)
        alts = np.asarray(alts, np.float64).ravel()
        # slide each point along the view dir onto the alt=0 plane
        t = alts / (-v[2])
        e_g = easts + t * v[0]
        n_g = norths + t * v[1]
        col = (e_g - (scene.e0 - scene.spec.extent / 2)) / gsd
        row = ((scene.n0 + scene.spec.extent / 2) - n_g) / gsd
        return col, row

    return proj, v


def fit_rpc(proj_fn, lon0, lat0, lon_scale, lat_scale, alt_offset, alt_scale,
            img_size):
    """Fit 20-term cubic RPC numerators (denominator = 1) to a projection by
    least squares over a normalized 9x9x7 grid — the standard way vendor
    RPCs are produced from physical camera models."""
    g = np.linspace(-1.0, 1.0, 9)
    ga = np.linspace(-1.0, 1.0, 7)
    LT, LN, A = np.meshgrid(g, g, ga, indexing="ij")
    nlat, nlon, nalt = LT.ravel(), LN.ravel(), A.ravel()
    lons = nlon * lon_scale + lon0
    lats = nlat * lat_scale + lat0
    alts = nalt * alt_scale + alt_offset
    cols, rows = proj_fn(lons, lats, alts)

    col_scale = row_scale = img_size / 2.0
    col_offset = row_offset = img_size / 2.0
    ncol = (cols - col_offset) / col_scale
    nrow = (rows - row_offset) / row_scale

    # design matrix of the 20 monomials (x=lat_n, y=lon_n, z=alt_n)
    x, y, z = nlat, nlon, nalt
    cols20 = [np.ones_like(x), y, x, z, y * x, y * z, x * z, y * y, x * x, z * z,
              x * y * z, y**3, y * x * x, y * z * z, y * y * x, x**3,
              x * z * z, y * y * z, x * x * z, z**3]
    M = np.stack(cols20, axis=1)
    col_num, *_ = np.linalg.lstsq(M, ncol, rcond=None)
    row_num, *_ = np.linalg.lstsq(M, nrow, rcond=None)
    den = np.zeros(20)
    den[0] = 1.0

    d = {
        "lat_offset": lat0, "lat_scale": lat_scale,
        "lon_offset": lon0, "lon_scale": lon_scale,
        "alt_offset": alt_offset, "alt_scale": alt_scale,
        "col_offset": col_offset, "col_scale": col_scale,
        "row_offset": row_offset, "row_scale": row_scale,
        "col_num": col_num.tolist(), "col_den": den.tolist(),
        "row_num": row_num.tolist(), "row_den": den.tolist(),
    }
    # sanity: fit residual must be sub-centimeter in image space
    fit_col = apply_poly(col_num, x, y, z)
    assert float(np.abs(fit_col - ncol).max()) < 1e-6, "RPC fit did not converge"
    return d


def generate_scene(out_dir, spec: SyntheticSceneSpec = None, aoi_id="SYN_068"):
    """Write a complete synthetic dataset under ``out_dir``.

    Layout: root jsons + train.txt/test.txt + images/ + truth/{aoi}_DSM.tif,
    {aoi}_CLS.tif, {aoi}_DSM.txt. Returns a dict of useful paths.
    """
    spec = spec or SyntheticSceneSpec()
    rng = np.random.default_rng(spec.seed)
    scene = SyntheticScene(spec)
    os.makedirs(out_dir, exist_ok=True)
    img_dir = os.path.join(out_dir, "images")
    gt_dir = os.path.join(out_dir, "truth")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)

    # degree half-ranges covering the scene with margin
    m_per_deg_lat = 111320.0
    m_per_deg_lon = m_per_deg_lat * np.cos(np.radians(spec.lat0))
    lat_scale = spec.extent * 0.75 / m_per_deg_lat
    lon_scale = spec.extent * 0.75 / m_per_deg_lon
    alt_offset = (spec.max_alt + spec.min_alt) / 2
    alt_scale = (spec.max_alt - spec.min_alt) / 2 + 3.0
    gsd = spec.extent / spec.img_size

    # Diverse view zenith angles: height-to-parallax leverage needs oblique
    # views (20 m of relief at zen 38 deg -> ~16 m of ground displacement).
    n_total = spec.n_views + spec.n_test_views
    view_az = np.linspace(0, 360, n_total, endpoint=False) + 13.0
    view_el = 10.0 + 14.0 * (np.arange(n_total) % 3)          # zenith: 10/24/38
    sun_az = (np.linspace(0, 360, n_total, endpoint=False) + 155.0) % 360
    sun_el = 30.0 + 30.0 * ((np.arange(n_total) % 4) / 3.0)   # above horizon

    names = []
    from eonerf_code_tpu_torch.data.satellite import cast_rays

    # RPC miscalibration: rendered through the TRUE camera, published with a
    # biased RPC (row/col offsets shifted) — vendor RPCs are typically off
    # by a few pixels and EO-NeRF's bundle adjustment learns the per-image
    # correction. Separate rng stream so bias=0 scenes stay bit-identical
    # and enabling bias leaves the radiometric jitter draws unchanged.
    # Test views keep clean RPCs so held-out PSNR stays meaningful.
    bias_rng = np.random.default_rng(spec.seed + 777)
    rpc_biases = {}

    for i in range(n_total):
        proj_fn, _v = _orthographic_projection(scene, view_az[i], view_el[i], gsd, spec.img_size)
        rpc_dict = fit_rpc(proj_fn, spec.lon0, spec.lat0, lon_scale, lat_scale,
                           alt_offset, alt_scale, spec.img_size)
        rpc = RPCModel(rpc_dict)

        # render the view through the same ray model the pipeline will use
        cols, rows = np.meshgrid(np.arange(spec.img_size), np.arange(spec.img_size))
        rays = cast_rays(cols.ravel(), rows.ravel(), rpc, spec.min_alt, spec.max_alt, utm=True)
        o, d, fars = rays[:, :3].astype(np.float64), rays[:, 3:6].astype(np.float64), rays[:, 7].astype(np.float64)
        _, hit, _ = scene.march(o, d, fars)

        sun_vec = dir_vec_from_el_az(90 - sun_el[i], sun_az[i])  # toward ground
        s = scene.sun_visibility(hit, sun_vec)[:, None]
        albedo = scene.albedo(hit[:, 0], hit[:, 1])
        ambient = np.asarray(spec.ambient_color)[None, :]
        rgb = albedo * (s + (1 - s) * 0.2 * ambient)

        if spec.radiometric_jitter > 0:
            a_j = 1.0 + rng.normal(0, spec.radiometric_jitter, 3)
            b_j = rng.normal(0, spec.radiometric_jitter / 2, 3)
            rgb = a_j[None] * rgb + b_j[None]
        rgb = np.clip(rgb, 0, 1).reshape(spec.img_size, spec.img_size, 3)

        name = f"{aoi_id}_{i:03d}"
        names.append(name)
        published_rpc = dict(rpc_dict)
        if spec.rpc_bias_px > 0 and i < spec.n_views:
            dc, dr = bias_rng.uniform(-spec.rpc_bias_px, spec.rpc_bias_px, 2)
            published_rpc["col_offset"] = rpc_dict["col_offset"] + dc
            published_rpc["row_offset"] = rpc_dict["row_offset"] + dr
            rpc_biases[name] = (float(dc), float(dr))
        write_geotiff(os.path.join(img_dir, name + ".tif"),
                      (rgb.transpose(2, 0, 1) * 255).astype(np.uint8),
                      crs=CRS.from_utm_zone(scene.zone, scene.south),
                      transform=Affine(gsd, 0, scene.e0 - spec.extent / 2,
                                       0, -gsd, scene.n0 + spec.extent / 2))
        write_json({
            "img": name + ".tif",
            "height": spec.img_size, "width": spec.img_size,
            "sun_elevation": float(sun_el[i]), "sun_azimuth": float(sun_az[i]),
            "acquisition_date": f"202001{(i % 28) + 1:02d}120000",
            "min_alt": spec.min_alt, "max_alt": spec.max_alt,
            "rpc": published_rpc,
            "geojson": {"center": [spec.lon0, spec.lat0]},
        }, os.path.join(out_dir, name + ".json"))

    with open(os.path.join(out_dir, "train.txt"), "w") as f:
        f.write("\n".join(n + ".json" for n in names[:spec.n_views]) + "\n")
    with open(os.path.join(out_dir, "test.txt"), "w") as f:
        f.write("\n".join(n + ".json" for n in names[spec.n_views:]) + "\n")

    # GT DSM + CLS over the inner 80% of the scene (avoids edge effects)
    res = spec.dsm_resolution
    size = int(spec.extent * 0.8 / res)
    xoff = scene.e0 - size * res / 2
    yoff_bottom = scene.n0 - size * res / 2
    xs = xoff + (np.arange(size) + 0.5) * res
    ys = (yoff_bottom + size * res) - (np.arange(size) + 0.5) * res
    E, N = np.meshgrid(xs, ys)
    dsm = scene.height(E, N).astype(np.float32)
    tr = Affine(res, 0, xoff, 0, -res, yoff_bottom + size * res)
    crs = CRS.from_utm_zone(scene.zone, scene.south)
    write_geotiff(os.path.join(gt_dir, f"{aoi_id}_DSM.tif"), dsm, crs=crs,
                  transform=tr, nodata=float("nan"))
    write_geotiff(os.path.join(gt_dir, f"{aoi_id}_CLS.tif"),
                  np.full((size, size), 2, np.uint8), crs=crs, transform=tr)
    np.savetxt(os.path.join(gt_dir, f"{aoi_id}_DSM.txt"),
               np.array([xoff, yoff_bottom, size, res]))

    return {"root_dir": out_dir, "img_dir": img_dir, "gt_dir": gt_dir,
            "aoi_id": aoi_id, "names": names, "rpc_biases_px": rpc_biases}
