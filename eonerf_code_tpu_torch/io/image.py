"""Image loading helpers (satellite RGB crops, masks, synthetic renders).

Mirrors the behavior of the reference loader (datasets/satellite.py:152-172):
values scaled to [0, 1], grayscale PNGs tiled to 3 channels, optional
antialiased bicubic downscale. The downscale uses torch's CPU
`interpolate(antialias=True)`, which is numerically identical to the
torchvision `Resize` the reference uses.
"""

import numpy as np


def _resize_bicubic(img_hwc, h, w):
    import torch
    import torch.nn.functional as F

    t = torch.from_numpy(np.ascontiguousarray(img_hwc.transpose(2, 0, 1)))[None].float()
    out = F.interpolate(t, size=(h, w), mode="bicubic", antialias=True)
    return out[0].numpy().transpose(1, 2, 0)


STANDARD_FULL_SCALES = (255.0, 1023.0, 2047.0, 4095.0, 16383.0, 65535.0)


def full_scale_for(data_max):
    """Smallest standard integer full-scale (8/10/11/12/14/16-bit) that
    holds ``data_max``. EO payload bit depth is rarely the container bit
    depth (11-bit WorldView in uint16), so dividing by the container max
    crushes the data toward 0."""
    return next((fs for fs in STANDARD_FULL_SCALES if fs >= data_max),
                float(data_max))


def image_payload_stats(img_path):
    """(data_max, int_max) of one raster: nanmax of the payload with nodata
    excluded, and the container integer dtype max (None for float rasters).
    Used to derive ONE radiometric scale per scene — see
    `scene_radiometric_scale`."""
    p = str(img_path)
    if p.endswith((".tif", ".tiff")):
        from eonerf_code_tpu_torch.io.geotiff import GeoTiffFile

        f = GeoTiffFile(p)
        src = f.read()
        raw = src.astype(np.float64)
        if f.nodata is not None and not np.isnan(f.nodata):
            raw = np.where(raw == f.nodata, np.nan, raw)
    elif p.endswith(".png"):
        from PIL import Image

        src = np.asarray(Image.open(p))
        raw = src.astype(np.float64)
    else:
        raise ValueError(f"unknown image extension: {p}")
    int_max = (float(np.iinfo(src.dtype).max)
               if np.issubdtype(src.dtype, np.integer) else None)
    data_max = float(np.nanmax(raw)) if raw.size else 0.0
    return data_max, int_max


def scene_radiometric_scale(img_paths, cache_path=None):
    """One radiometric divisor for a whole scene/sensor.

    The per-image inference in `load_rgb_image` divides each crop by the
    smallest standard full-scale >= ITS OWN max — two crops of the same
    sensor whose maxes straddle a boundary get inconsistent radiometry,
    which EO-NeRF's multi-view shading model assumes away. This computes the
    scale ONCE over every view of the scene (train + test rosters) and
    returns it; `load_rgb_image(..., scale=...)` then applies the same
    divisor to every view.

    Returns None when the default path is already consistent (uint8 or
    float rasters: every image divides by 255 regardless of content).
    Result is cached as JSON keyed by the image list — full paths + file
    size + mtime, NOT basenames alone: a re-export of the same filenames
    into another directory (different container/radiometry) must invalidate
    the cache, or every view silently reuses the stale scale.
    """
    import json
    import os

    img_paths = [str(p) for p in img_paths]
    key = [[os.path.abspath(p), os.path.getsize(p),
            int(os.path.getmtime(p) * 1000)] for p in img_paths]
    if cache_path and os.path.exists(cache_path):
        with open(cache_path) as fh:
            d = json.load(fh)
        if d.get("key") == key:
            return d["scale"]
    # container dtype check on the first view only: uint8 containers take
    # the trivial /255 path for every image, no scene pass needed. Float
    # containers USUALLY hold the 0..255 float convention (the reference's
    # pansharpened JAX_NEW/IARPA crops, datasets/satellite.py:163 divides
    # by 255) — but raw-DN float exports (11-bit payloads stored as
    # float32) would clip 60%+ of pixels to white under /255, so floats
    # whose scene-wide max clearly exceeds that convention (>300) get the
    # same payload-bit-depth full-scale treatment as uint16.
    data_max0, int_max0 = image_payload_stats(img_paths[0])
    if int_max0 is not None and int_max0 <= 255:
        scale = None
    else:
        # the >300 raw-DN decision must see the SCENE-WIDE max, not the
        # first view's: a dark first view (max < 300) must not commit the
        # whole scene to /255 while brighter views clip white — and the
        # answer must not depend on roster order.
        data_max = max(image_payload_stats(p)[0] for p in img_paths)
        if int_max0 is None:
            scale = full_scale_for(data_max) if data_max > 300.0 else None
        else:
            scale = full_scale_for(data_max) if data_max > 1.1 else None
    if cache_path:
        os.makedirs(os.path.dirname(os.path.abspath(cache_path)), exist_ok=True)
        with open(cache_path, "w") as fh:
            json.dump({"key": key, "scale": scale}, fh)
    return scale


def load_rgb_image(img_path, downscale_factor=1, scale=None):
    """Load a .tif/.png image as float (h, w, 3) in [0, 1].

    Reference: datasets/satellite.py:152-172 (`load_rgb_geotiff`), hardened
    for real-metadata quirks the reference crashes or saturates on:
    - integer rasters with values above 1 scale by their dtype range
      (uint8 -> /255, identical to the reference; uint16 WorldView crops ->
      /65535 instead of the reference's clip-to-white); binary 0/1 masks
      pass through untouched either way;
    - multispectral rasters (>3 bands) keep the first 3 bands;
    - nodata values (NaN or the file's declared nodata) map to 0.

    ``scale``: explicit full-scale divisor (from `scene_radiometric_scale`)
    so every view of a scene is normalized identically; when None the scale
    is inferred per image (standalone/mask use).
    """
    p = str(img_path)
    nodata = None
    if p.endswith(".tif") or p.endswith(".tiff"):
        from eonerf_code_tpu_torch.io.geotiff import GeoTiffFile

        f = GeoTiffFile(p)
        raw = f.read()
        nodata = f.nodata
        img = raw.transpose(1, 2, 0)
    elif p.endswith(".png"):
        from PIL import Image

        img = np.asarray(Image.open(p))
        if img.ndim == 2:
            img = img[:, :, None]
    else:
        raise ValueError(f"unknown image extension: {p}")

    int_max = (float(np.iinfo(img.dtype).max)
               if np.issubdtype(img.dtype, np.integer) else None)
    img = img.astype(np.float64)
    if nodata is not None and not np.isnan(nodata):
        img = np.where(img == nodata, np.nan, img)
    if img.shape[2] == 1:
        img = np.tile(img, (1, 1, 3))
    elif img.shape[2] == 2:
        img = np.tile(img[:, :, :1], (1, 1, 3))
    else:
        img = img[:, :, :3]

    if np.nanmax(img) > 1.1:  # reference heuristic; keeps binary 0/1 masks
        if scale is not None:
            # scene-wide divisor (scene_radiometric_scale): every view of
            # the scene is normalized identically
            img = img / scale
        elif int_max is not None and int_max > 255:
            # integer rasters whose payload bit depth is smaller than the
            # container (11-bit WorldView in uint16, 16-bit PNG decoded to
            # int32 by PIL): dividing by the container max crushes the data
            # toward 0. Use the smallest standard full-scale that holds the
            # data max. NOTE: per-image inference — fine standalone, but
            # multi-view datasets should pass the scene-wide `scale`.
            img = img / full_scale_for(float(np.nanmax(img)))
        elif int_max is None and np.nanmax(img) > 300.0:
            # float raster far beyond the 0..255 float convention (raw-DN
            # pansharpened export): /255 would clip most pixels to white
            # (the reference does exactly that, datasets/satellite.py:163).
            # Same payload full-scale rule as uint16.
            img = img / full_scale_for(float(np.nanmax(img)))
        else:
            img = img / 255.0
    img = np.nan_to_num(img, nan=0.0)
    img = np.clip(img, 0, 1)
    if downscale_factor > 1:
        h, w = img.shape[:2]
        img = _resize_bicubic(img.astype(np.float32), int(h // downscale_factor), int(w // downscale_factor))
    return np.clip(img, 0, 1).astype(np.float32)


def save_image_like(output_path, array_chw, source_path=None, crs=None, transform=None):
    """Save a (C, H, W) float array as GeoTIFF, inheriting georeferencing
    from ``source_path`` when given (reference: datasets/satellite.py:174-193)."""
    from eonerf_code_tpu_torch.io.geotiff import GeoTiffFile, write_geotiff

    arr = np.asarray(array_chw, dtype=np.float32)
    if arr.ndim == 2:
        arr = arr[None]
    if source_path is not None:
        try:
            src = GeoTiffFile(source_path)
            crs = crs or src.crs
            transform = transform or src.transform
        except (OSError, ValueError):
            pass
    write_geotiff(output_path, arr, crs=crs, transform=transform)
