"""Raster I/O without GDAL.

The reference leans on rasterio/GDAL (C libraries) for every GeoTIFF
read/write and even shells out to the `gdal_translate` binary with a
10-second sleep inside the validation loop (reference: sat_utils.py:161-163).
This package replaces all of that with an in-process, dependency-free TIFF
codec plus windowed-crop helpers, so evaluation never spawns subprocesses.
"""

from eonerf_code_tpu_torch.io.geotiff import Affine, CRS, GeoTiffFile, open_geotiff, read_geotiff, write_geotiff
from eonerf_code_tpu_torch.io.image import load_rgb_image, save_image_like

__all__ = [
    "Affine",
    "CRS",
    "GeoTiffFile",
    "open_geotiff",
    "read_geotiff",
    "write_geotiff",
    "load_rgb_image",
    "save_image_like",
]
