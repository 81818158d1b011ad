"""Satellite dataset: JSON metadata -> the (N, 11) ray tensor, plus scene
normalization, ray caching, depth/shadow priors and DSM extraction glue.

Functional mirror of the reference `SatelliteDataset`
(datasets/satellite.py:273-819) with the host pipeline rebuilt on the
framework's own geo/io stacks (no rasterio/rpcm/pyproj):

- ray casting by RPC localization at max_alt (origin plane) and min_alt
  (far plane), UTM or ECEF frames (reference :65-121);
- scene normalization into the [-1,1]^3 cube from 8 corner rays per image,
  persisted as `scene.loc_utm` / `scene.loc_ecef` (reference :377-404);
- per-image ray caches: a `<img_id>.npy` with the raw (N, 8) geometry (the
  expensive RPC part) or a fully-processed normalized (N, 11) tensor — the
  column-count check is the cache contract (reference :440-453). The
  reference's mixed cached/uncached normalization bug (a single `recompute`
  flag covering all images, :472-476) is fixed here by processing per image.
- float64 denormalization for the DSM path (reference :514-517).

Two splits: ``train`` (the ray pool) and ``val`` (the first train view as
an overfit probe, then the test roster, one view at a time through
``get_val_sample``), and the pixel/ray index algebra over the train pool.
Host numpy throughout; the DSM rasterisation runs ``ops/raster.py`` on
float64 CPU tensors.
"""

import glob
import json
import os

import numpy as np
import torch

from eonerf_code_tpu_torch.geo import RPCModel, latlon_to_ecef, utm_from_latlon, utm_zonestring_from_lonlat
from eonerf_code_tpu_torch.io.image import load_rgb_image


def read_json(path):
    with open(path) as f:
        return json.load(f)


def write_json(d, path):
    with open(path, "w") as f:
        json.dump(d, f, indent=2)


def get_file_id(path):
    return os.path.splitext(os.path.basename(path))[0]


def alt_bounds(d):
    """(min_alt, max_alt) from the metadata dict. Real DFC2019/IARPA jsons
    carry explicit min_alt/max_alt; some exports omit them, in which case
    the RPC's own altitude validity range (alt_offset +- alt_scale) is the
    defined bound of the camera model and is used as the fallback."""
    if "min_alt" in d and "max_alt" in d:
        return float(d["min_alt"]), float(d["max_alt"])
    rpc = d["rpc"]
    off, sc = float(rpc["alt_offset"]), float(rpc["alt_scale"])
    return off - sc, off + sc


def scaling_params(v):
    """Scale/offset mapping a vector's range onto [-1, 1] (sat_utils.py:32-39)."""
    vec = np.asarray(v).ravel()
    scale = (vec.max() - vec.min()) / 2
    offset = vec.min() + scale
    return scale, offset


def dir_vec_from_el_az(elevation_deg, azimuth_deg):
    """Unit vector of incoming light. Convention per the reference
    (datasets/satellite.py:57-63): elevation 0 at nadir, 90 at frontal; the
    returned vector points from the sun TOWARD the ground."""
    el = np.radians(90 - elevation_deg)
    az = np.radians(azimuth_deg)
    return -1.0 * np.array([np.sin(az) * np.cos(el), np.cos(az) * np.cos(el), np.sin(el)])


def cast_rays(cols, rows, rpc, min_alt, max_alt, utm=True):
    """RPC ray casting: localize each pixel at max_alt (origin) and min_alt
    (far end). Returns an (N, 8) float array [o(3), d(3), near, far] in UTM
    or ECEF world coordinates (reference :65-121)."""
    cols = np.asarray(cols, np.float64).ravel()
    rows = np.asarray(rows, np.float64).ravel()
    min_alts = np.full(cols.shape, float(min_alt))
    max_alts = np.full(cols.shape, float(max_alt))

    lons, lats = rpc.localization(cols, rows, max_alts)
    if utm:
        easts, norths = utm_from_latlon(lats, lons)
        xyz_near = np.stack([easts, norths, max_alts], 1)
        lons, lats = rpc.localization(cols, rows, min_alts)
        easts, norths = utm_from_latlon(lats, lons)
        xyz_far = np.stack([easts, norths, min_alts], 1)
    else:
        x, y, z = latlon_to_ecef(lats, lons, max_alts)
        xyz_near = np.stack([x, y, z], 1)
        lons, lats = rpc.localization(cols, rows, min_alts)
        x, y, z = latlon_to_ecef(lats, lons, min_alts)
        xyz_far = np.stack([x, y, z], 1)

    d = xyz_far - xyz_near
    fars = np.linalg.norm(d, axis=1)
    rays_d = d / fars[:, None]
    nears = np.zeros_like(fars)
    return np.hstack([xyz_near, rays_d, nears[:, None], fars[:, None]]).astype(np.float32)


def normalize_rays(rays, scene_offset, scene_scale):
    """Map world rays into the normalized cube (reference :124-139).

    Handles per-axis scales (UTM mode): origins and far endpoints are
    normalized independently and the direction re-derived, so anisotropic
    scaling stays consistent. Sun directions (cols 8:11, if present) are
    rescaled per-axis and renormalized.
    """
    rays = np.asarray(rays, np.float64)
    off = np.asarray(scene_offset, np.float64)
    sc = np.asarray(scene_scale, np.float64)
    rays_o = rays[:, :3]
    rays_e = rays[:, :3] + rays[:, 3:6] * rays[:, 7:8]
    o_n = (rays_o - off) / sc
    e_n = (rays_e - off) / sc
    d = e_n - o_n
    fars = np.linalg.norm(d, axis=1)
    rays_d = d / fars[:, None]
    nears = np.zeros_like(fars)
    out = np.hstack([o_n, rays_d, nears[:, None], fars[:, None]])
    if rays.shape[1] == 11:
        sun_d = rays[:, 8:11] / sc
        sun_d = sun_d / np.linalg.norm(sun_d, axis=1)[:, None]
        out = np.hstack([out, sun_d])
    return out.astype(np.float32)


def normalize_rays_ecef(rays, scene_offset, scene_scale):
    """Scalar-scale ECEF normalization (reference `old_normalize_rays`
    :141-150): offset+scale positions, scale near/far, sun dirs untouched."""
    rays = np.asarray(rays, np.float64).copy()
    scale = float(np.max(np.asarray(scene_scale)))  # scalar by construction
    rays[:, 0:3] = (rays[:, 0:3] - np.asarray(scene_offset)) / scale
    rays[:, 6:8] = rays[:, 6:8] / scale
    return rays.astype(np.float32)


class SatelliteScene:
    """Scene-level metadata shared by train/val splits: normalization,
    UTM zone, json roster."""

    def __init__(self, root_dir, img_downscale=1.0, utm=True):
        self.root_dir = root_dir
        self.img_downscale = float(img_downscale)
        self.utm = utm
        loc_path = os.path.join(root_dir, "scene.loc_{}".format("utm" if utm else "ecef"))
        if not os.path.exists(loc_path):
            self._init_scaling_params(loc_path)
        d = read_json(loc_path)
        self.scene_offset = np.array([d["X_offset"], d["Y_offset"], d["Z_offset"]], np.float64)
        per_axis = np.array([d["X_scale"], d["Y_scale"], d["Z_scale"]], np.float64)
        self.scene_scale = per_axis if utm else np.full(3, per_axis.max())
        first_train = self._split_files("train.txt")[0]
        rpc_d = read_json(os.path.join(root_dir, first_train))["rpc"]
        self.utm_zonestring = utm_zonestring_from_lonlat(rpc_d["lon_offset"], rpc_d["lat_offset"])

    def _split_files(self, name):
        """Roster file -> list of json basenames. Tolerates real-world split
        files: CRLF line endings, stray whitespace, blank lines."""
        with open(os.path.join(self.root_dir, name)) as f:
            lines = [p.strip() for p in f.read().split("\n")]
        return [p for p in lines if ".json" in p]

    def _init_scaling_params(self, loc_path):
        """8 corner rays per image over every json in the dir
        (reference :377-404)."""
        all_rays = []
        for json_p in sorted(glob.glob(os.path.join(self.root_dir, "*.json"))):
            d = read_json(json_p)
            h = int(d["height"] // self.img_downscale)
            w = int(d["width"] // self.img_downscale)
            rpc = RPCModel(d["rpc"]).rescaled(1.0 / self.img_downscale)
            cols = np.array(2 * [0, w - 1, w - 1, 0], np.float64)
            rows = np.array(2 * [0, 0, h - 1, h - 1], np.float64)
            min_alt, max_alt = alt_bounds(d)
            all_rays.append(cast_rays(cols, rows, rpc, min_alt, max_alt, utm=self.utm))
        rays = np.concatenate(all_rays, 0).astype(np.float64)
        near = rays[:, :3]
        far = rays[:, :3] + rays[:, 7:8] * rays[:, 3:6]
        pts = np.concatenate([near, far], 0)
        out = {}
        out["X_scale"], out["X_offset"] = scaling_params(pts[:, 0])
        out["Y_scale"], out["Y_offset"] = scaling_params(pts[:, 1])
        out["Z_scale"], out["Z_offset"] = scaling_params(pts[:, 2])
        write_json({k: float(v) for k, v in out.items()}, loc_path)


class SatelliteDataset:
    """Train/val views as flat numpy arrays ready for device upload. The
    caches it writes where they are missing (the per-image ray casts and
    priors under ``cache_dir``, ``scene.radiometry``) take no lock: on a
    data axis rank 0 builds the dataset first and the other ranks then read
    them (``parallel.mesh.Mesh.main_first``, in the trainer and the eval
    run)."""

    def __init__(self, root_dir, img_dir=None, split="train", img_downscale=1.0,
                 utm=True, cache_dir=None, prior_dsm_path=None, prior_conf_path=None,
                 shadow_masks_dir=None, subset=None):
        self.root_dir = root_dir
        self.img_dir = img_dir or root_dir
        self.split = split
        self.train = split == "train"
        self.cache_dir = cache_dir
        self.shadow_masks_dir = shadow_masks_dir
        self.scene = SatelliteScene(root_dir, img_downscale, utm)
        self.img_downscale = self.scene.img_downscale
        self.utm = utm
        # ONE radiometric divisor for the whole scene (train + test views):
        # per-image scale inference can split views of the same sensor
        # across bit-depth boundaries (io/image.py scene_radiometric_scale)
        self.radiometric_scale = self._scene_radiometric_scale()

        if self.train:
            files = self.scene._split_files("train.txt")
            if subset is not None and subset > 1:
                files = files[:subset]
            self.json_files = [os.path.join(root_dir, p) for p in files]
            (self.all_rays, self.all_rgbs, self.all_ids_img,
             self.all_img_shapes, self.all_rpcs) = self.load_data(self.json_files)
        else:
            files = self.scene._split_files("test.txt")
            train_files = self.scene._split_files("train.txt")
            # val[0] is the first train view, an overfit probe (reference
            # :363-375) with image id 0; test ids continue after the train
            # roster
            self.json_files = [os.path.join(root_dir, train_files[0])] + [
                os.path.join(root_dir, p) for p in files]
            self.all_ids_img = [0] + [len(train_files) + i for i in range(len(files))]

        self.prior_depths, self.prior_confs = None, None
        if prior_dsm_path is not None:
            self.prior_depths, self.prior_confs = self.load_depth_priors_from_dsm(
                prior_dsm_path, prior_conf_path)
        self.prior_shadows = None
        if shadow_masks_dir is not None:
            self.prior_shadows = self.load_shadow_masks(shadow_masks_dir)

    # ---- ray/image loading ----

    def alt_envelope(self):
        """(min_alt, max_alt) over every view's metadata — the scene's
        altitude envelope. Drives automatic sampler selection (compact
        envelopes tolerate occupancy tightening; wide ones need hierarchical
        sampling — STATUS.md round-2 finding)."""
        los, his = [], []
        for p in self.json_files:
            lo, hi = alt_bounds(read_json(p))
            los.append(lo)
            his.append(hi)
        return (min(los), max(his)) if los else (0.0, 0.0)

    def _scene_radiometric_scale(self):
        """Scene-wide radiometric divisor over the train + test rosters
        (None = trivial /255 path; cached next to the ray cache)."""
        from eonerf_code_tpu_torch.io.image import scene_radiometric_scale

        files = self.scene._split_files("train.txt")
        if os.path.exists(os.path.join(self.root_dir, "test.txt")):
            files = files + self.scene._split_files("test.txt")
        paths = []
        for p in files:
            d = read_json(os.path.join(self.root_dir, p))
            cand = os.path.join(self.img_dir, d["img"])
            if os.path.exists(cand):
                paths.append(cand)
        if not paths:
            return None
        # NOT *.json — the scene dir glob treats every .json as view metadata
        cache = os.path.join(self.cache_dir or self.root_dir, "scene.radiometry")
        return scene_radiometric_scale(paths, cache_path=cache)

    def _cache_path(self, img_id):
        return None if self.cache_dir is None else os.path.join(self.cache_dir, img_id + ".npy")

    def load_view(self, json_path):
        """One image -> (rays_norm (N,11) f32, rgbs (N,3) f32, h, w, rpc)."""
        d = read_json(json_path)
        img_p = os.path.join(self.img_dir, d["img"])
        img_id = get_file_id(d["img"])
        img = load_rgb_image(img_p, self.img_downscale, scale=self.radiometric_scale)
        h = int(d["height"] // self.img_downscale)
        w = int(d["width"] // self.img_downscale)
        if img.shape[:2] != (h, w):
            # real crops are occasionally a pixel off vs their json metadata
            # (rounding at export); rays are cast from the json dims, so the
            # raster is cropped/padded to agree instead of silently
            # misaligning the (rays, rgbs) pairing downstream
            ph, pw = max(h - img.shape[0], 0), max(w - img.shape[1], 0)
            if ph or pw:
                img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
            img = img[:h, :w]
        rgbs = img.reshape(-1, 3)
        rpc = RPCModel(d["rpc"]).rescaled(1.0 / self.img_downscale)

        cache_path = self._cache_path(img_id)
        raw = None
        if cache_path and os.path.exists(cache_path):
            cached = np.load(cache_path)
            if cached.shape[1] == 11:  # fully-processed cache
                return cached.astype(np.float32), rgbs, h, w, rpc
            if cached.shape[1] == 8:
                raw = cached
        if raw is None:
            cols, rows = np.meshgrid(np.arange(w), np.arange(h))
            min_alt, max_alt = alt_bounds(d)
            raw = cast_rays(cols.ravel(), rows.ravel(), rpc,
                            min_alt, max_alt, utm=self.utm)
            if cache_path:
                os.makedirs(os.path.dirname(cache_path), exist_ok=True)
                np.save(cache_path, raw)

        sun_d = dir_vec_from_el_az(90 - float(d["sun_elevation"]), float(d["sun_azimuth"]))
        if not self.utm:
            # reference :497-498 parity (pinned by test_ecef_mode): the
            # z-up el/az vector is merely sign-flipped, NOT rotated into
            # the local ENU basis — geometrically wrong in an ECEF cube,
            # which is part of why the reference's --ecef prototype is
            # broken. Kept for training parity; the EVAL nadir sweep is
            # fixed for real (render/nadir.py enu_frame) since a wrong
            # camera frame corrupts the DSM itself, while a wrong sun only
            # degrades the (prototype-mode) shading.
            sun_d = -sun_d
        sun_dirs = np.tile(sun_d, (raw.shape[0], 1)).astype(np.float32)
        rays = np.hstack([raw, sun_dirs])
        if self.utm:
            rays = normalize_rays(rays, self.scene.scene_offset, self.scene.scene_scale)
        else:
            rays = normalize_rays_ecef(rays, self.scene.scene_offset, self.scene.scene_scale)
        return rays.astype(np.float32), rgbs, h, w, rpc

    def load_data(self, json_files):
        all_rays, all_rgbs, all_ids, all_shapes, all_rpcs = [], [], [], [], []
        for t, json_p in enumerate(json_files):
            rays, rgbs, h, w, rpc = self.load_view(json_p)
            all_rays.append(rays)
            all_rgbs.append(rgbs)
            all_ids.append(np.full((rays.shape[0], 1), t, np.int32))
            all_shapes.append([h, w])
            all_rpcs.append(rpc)
        return (np.concatenate(all_rays, 0), np.concatenate(all_rgbs, 0),
                np.concatenate(all_ids, 0), np.asarray(all_shapes, np.int64), all_rpcs)

    def num_val_images(self):
        return len(self.json_files)

    def get_val_sample(self, i):
        """Validation view i as a dict (reference __getitem__ val branch)."""
        json_p = self.json_files[i]
        rays, rgbs, h, w, _ = self.load_view(json_p)
        return {"rays": rays, "rgbs": rgbs, "h": h, "w": w,
                "src_id": get_file_id(read_json(json_p)["img"]),
                "ts": np.zeros((rays.shape[0],), np.int32),   # the reference renders id 0
                "idx": i, "img_idx": self.all_ids_img[i]}

    # ---- pixel/ray index algebra over the train pool (reference :711-765) ----

    def first_ray_idx_of_img(self, img_idx):
        """Flat-ray index of pixel (0, 0) of image img_idx."""
        sizes = np.prod(self.all_img_shapes, axis=1)
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        return starts[np.asarray(img_idx)]

    def ray_index_from_colrow(self, cols, rows, img_idx):
        w = self.all_img_shapes[np.asarray(img_idx), 1]
        return self.first_ray_idx_of_img(img_idx) + np.asarray(rows) * w + np.asarray(cols)

    def colrow_from_ray_index(self, ray_idx):
        ray_idx = np.asarray(ray_idx)
        img_idx = self.all_ids_img[ray_idx, 0]
        pix = ray_idx - self.first_ray_idx_of_img(img_idx)
        w = self.all_img_shapes[img_idx, 1]
        return pix % w, pix // w, img_idx

    def patch_indices(self, idx, patch_size=0):
        """Flat-ray indices of a (patch_size x patch_size) patch around ray
        ``idx``, clamped at the image borders (reference
        `get_patch_from_index` :731-765); patch_size 0 returns idx itself."""
        if patch_size == 0:
            return np.asarray(idx)
        col, row, img_idx = (int(x[0]) for x in self.colrow_from_ray_index(np.asarray([idx])))
        h, w = self.all_img_shapes[img_idx]
        half = patch_size // 2
        c0 = np.clip(col - half, 0, w - patch_size)
        r0 = np.clip(row - half, 0, h - patch_size)
        cc, rr = np.meshgrid(np.arange(c0, c0 + patch_size), np.arange(r0, r0 + patch_size))
        return self.ray_index_from_colrow(cc.ravel(), rr.ravel(),
                                          np.full(patch_size ** 2, img_idx))

    # ---- DSM extraction ----

    def utmalt_from_depth(self, rays, depth):
        """Denormalize predicted depth to (easts, norths, alts) in float64
        (reference :502-533)."""
        rays = np.asarray(rays, np.float64)
        depth = np.asarray(depth, np.float64).reshape(-1, 1)
        xyz_n = rays[:, 0:3] + rays[:, 3:6] * depth
        xyz = xyz_n * self.scene.scene_scale + self.scene.scene_offset
        if self.utm:
            return xyz[:, 0], xyz[:, 1], xyz[:, 2]
        from eonerf_code_tpu_torch.geo import ecef_to_latlon
        lats, lons, alts = ecef_to_latlon(xyz[:, 0], xyz[:, 1], xyz[:, 2])
        easts, norths = utm_from_latlon(lats, lons)
        return easts, norths, alts

    def dsm_from_depth(self, rays, depth, dsm_path=None, resolution=0.5, roi=None):
        """Predicted depth -> gridded DSM GeoTIFF (reference :545-610)."""
        from eonerf_code_tpu_torch.ops.raster import rasterize_pointcloud
        from eonerf_code_tpu_torch.io.geotiff import Affine, CRS, write_geotiff
        from eonerf_code_tpu_torch.geo import latlon_to_zone_number, latitude_to_zone_letter

        easts, norths, alts = self.utmalt_from_depth(rays, depth)
        norths = np.where(norths < 0, norths + 10e6, norths)  # reference :560
        valid = np.asarray(depth).ravel() >= 0.0
        easts, norths, alts = easts[valid], norths[valid], alts[valid]

        if roi is not None:
            xoff, yoff = float(roi[0]), float(roi[1])
            xsize = ysize = int(roi[2])
            resolution = float(roi[3])
            yoff += ysize * resolution
        else:
            xoff = np.floor(easts.min() / resolution) * resolution
            xsize = int(1 + np.floor((easts.max() - xoff) / resolution))
            yoff = np.ceil(norths.max() / resolution) * resolution
            ysize = int(1 - np.floor((norths.min() - yoff) / resolution))

        dsm = rasterize_pointcloud(*(torch.from_numpy(np.ascontiguousarray(v, np.float64))
                                     for v in (easts, norths, alts)),
                                   xoff, yoff, resolution, xsize, ysize, radius=1).numpy()
        if dsm_path is not None:
            d = read_json(self.json_files[0])
            lat0, lon0 = d["rpc"]["lat_offset"], d["rpc"]["lon_offset"]
            zone = latlon_to_zone_number(lat0, lon0)
            south = latitude_to_zone_letter(lat0) < "N"
            write_geotiff(dsm_path, dsm.astype(np.float32),
                          crs=CRS.from_utm_zone(zone, south),
                          transform=Affine(resolution, 0.0, xoff, 0.0, -resolution, yoff),
                          nodata=float("nan"))
        return dsm

    # ---- priors ----

    def load_depth_priors_from_dsm(self, prior_dsm_path, prior_conf_path=None, json_files=None):
        """Reproject an external DSM into each view -> per-ray depth (+SGM
        confidence) priors, cached as `.depth.npy`/`.conf.npy`
        (reference :620-709)."""
        from eonerf_code_tpu_torch.eval.reproject import reproject_dsm_to_image

        json_files = json_files or self.json_files
        all_depths, all_confs = [], []
        for json_p in json_files:
            d = read_json(json_p)
            img_id = get_file_id(d["img"])
            h = int(d["height"] // self.img_downscale)
            w = int(d["width"] // self.img_downscale)
            rpc = RPCModel(d["rpc"]).rescaled(1.0 / self.img_downscale)

            cpath = None if self.cache_dir is None else os.path.join(self.cache_dir, img_id + ".depth.npy")
            if cpath and os.path.exists(cpath):
                depth = np.load(cpath)
            else:
                alts = reproject_dsm_to_image(prior_dsm_path, h, w, rpc).ravel()
                rays = self.load_view(json_p)[0].astype(np.float64)
                alts_n = (alts - self.scene.scene_offset[-1]) / self.scene.scene_scale[-1]
                depth = (alts_n - rays[:, 2]) / rays[:, 5]
                depth = np.where(np.isnan(depth), -1.0, depth).astype(np.float32)
                if cpath:
                    os.makedirs(os.path.dirname(cpath), exist_ok=True)
                    np.save(cpath, depth)
            all_depths.append(depth)

            if prior_conf_path is not None and os.path.exists(prior_conf_path):
                cpath2 = None if self.cache_dir is None else os.path.join(self.cache_dir, img_id + ".conf.npy")
                if cpath2 and os.path.exists(cpath2):
                    conf = np.load(cpath2)
                else:
                    conf = reproject_dsm_to_image(prior_dsm_path, h, w, rpc,
                                                  other_val_path=prior_conf_path).ravel()
                    conf = np.where(np.isnan(conf), -1.0, conf).astype(np.float32)
                    if cpath2:
                        np.save(cpath2, conf)
                all_confs.append(conf)

        depths = np.concatenate(all_depths, 0).astype(np.float32)
        confs = np.concatenate(all_confs, 0).astype(np.float32) if all_confs else None
        return depths, confs

    def load_shadow_masks(self, shadow_masks_dir, json_files=None):
        """Binary shadow priors: 0 = shadow, 1 = lit, threshold 0.3
        (reference :767-796)."""
        json_files = json_files or self.json_files
        masks = []
        for json_p in json_files:
            d = read_json(json_p)
            img_p = os.path.join(shadow_masks_dir, d["img"])
            if not os.path.exists(img_p):
                img_p = img_p.replace(".tif", ".png")
            m = load_rgb_image(img_p, self.img_downscale)[:, :, 0]
            m = (m > 0.3).astype(np.float32)
            masks.append(m.reshape(-1))
        return np.concatenate(masks, 0)
