"""DSM evaluation on the host: ROI crop, water masking, registration,
altitude MAE.

Port of the reference pipeline (sat_utils.py:133-256) with the
`os.system('gdal_translate ...')` + `time.sleep(10)` subprocess crop
(sat_utils.py:161-163) replaced by an in-process windowed nearest-neighbor
crop producing the same grid: the projection window [ulx, uly, lrx, lry] at
target resolution, sampled at output pixel centers.
"""

import os

import numpy as np

from eonerf_code_tpu_torch.eval.registration import apply_shift_arrays, compute_shift_arrays
from eonerf_code_tpu_torch.io.geotiff import Affine, GeoTiffFile, write_geotiff


def _read_nan(f: GeoTiffFile):
    """Band 1 as float64 with the nodata value as NaN."""
    data = f.read(1).astype(np.float64)
    if f.nodata is not None and not np.isnan(f.nodata):
        data = np.where(data == f.nodata, np.nan, data)
    return data


def crop_to_projwin(src: GeoTiffFile, ulx, uly, lrx, lry, resolution):
    """gdal_translate -projwin ulx uly lrx lry -tr res res equivalent
    (nearest-neighbor). Returns (array, transform)."""
    data = _read_nan(src)
    t = src.transform
    xsize = int(round((lrx - ulx) / resolution))
    ysize = int(round((uly - lry) / resolution))
    xc = ulx + (np.arange(xsize) + 0.5) * resolution
    yc = uly - (np.arange(ysize) + 0.5) * resolution
    cols = np.floor((xc - t.c) / t.a).astype(np.int64)
    rows = np.floor((yc - t.f) / t.e).astype(np.int64)
    out = np.full((ysize, xsize), np.nan)
    okc = (cols >= 0) & (cols < src.width)
    okr = (rows >= 0) & (rows < src.height)
    rr, cc = np.meshgrid(rows[okr], cols[okc], indexing="ij")
    out[np.ix_(okr, okc)] = data[rr, cc]
    return out, Affine(resolution, 0.0, ulx, 0.0, -resolution, uly)


def _load_water_mask(gt_mask_path):
    """Water mask from the CLS raster (class 9) with the WATER.png override
    (sat_utils.py:165-176)."""
    water = GeoTiffFile(gt_mask_path).read(1) == 9
    png = gt_mask_path.replace("CLS.tif", "WATER.png")
    if gt_mask_path.endswith("CLS.tif") and os.path.exists(png):
        from PIL import Image

        water = np.asarray(Image.open(png)) == 0
    return water


def dsm_pointwise_diff(in_dsm_path, gt_dsm_path, dsm_metadata, gt_mask_path=None,
                       out_rdsm_path=None, out_err_path=None):
    """Signed altitude error map of a predicted DSM vs lidar GT
    (sat_utils.py:133-224). dsm_metadata = (xoff, yoff, size, resolution)."""
    xoff, yoff = float(dsm_metadata[0]), float(dsm_metadata[1])
    xsize = ysize = int(dsm_metadata[2])
    resolution = float(dsm_metadata[3])
    ulx, uly = xoff, yoff + ysize * resolution
    lrx, lry = xoff + xsize * resolution, yoff

    src = GeoTiffFile(in_dsm_path)
    pred_dsm, crop_transform = crop_to_projwin(src, ulx, uly, lrx, lry, resolution)

    if gt_mask_path is not None:
        water = _load_water_mask(gt_mask_path)
        h_ = min(water.shape[0], pred_dsm.shape[0])
        w_ = min(water.shape[1], pred_dsm.shape[1])
        wm = np.zeros(pred_dsm.shape, dtype=bool)
        wm[:h_, :w_] = water[:h_, :w_]
        pred_dsm = np.where(wm, np.nan, pred_dsm)

    gt_dsm = _read_nan(GeoTiffFile(gt_dsm_path))
    dx, dy, a, b = compute_shift_arrays(gt_dsm, pred_dsm, scaling=False)
    pred_rdsm = apply_shift_arrays(pred_dsm, dx, dy, a, b)

    h = min(pred_rdsm.shape[0], gt_dsm.shape[0])
    w = min(pred_rdsm.shape[1], gt_dsm.shape[1])
    pred_rdsm = np.clip(pred_rdsm, np.nanmin(gt_dsm) - 10, np.nanmax(gt_dsm) + 10)
    err = pred_rdsm[:h, :w] - gt_dsm[:h, :w]

    if out_rdsm_path is not None:
        write_geotiff(out_rdsm_path, pred_rdsm.astype(np.float32), crs=src.crs,
                      transform=crop_transform, nodata=float("nan"))
    if out_err_path is not None:
        write_geotiff(out_err_path, err.astype(np.float32), crs=src.crs,
                      transform=crop_transform, nodata=float("nan"))
    return err


def dsm_mae(in_dsm_path, gt_dsm_path, dsm_metadata, gt_mask_path=None):
    """Mean |altitude error| without writing any outputs (sat_utils.py:258)."""
    err = dsm_pointwise_diff(in_dsm_path, gt_dsm_path, dsm_metadata, gt_mask_path=gt_mask_path)
    return float(np.nanmean(np.abs(err.ravel())))


def compute_mae_and_save_dsm_diff(pred_dsm_path, src_id, gt_dir, out_dir, epoch_number, aoi_id,
                                  save=True):
    """Resolve the per-AOI GT rasters and return mean |altitude error|
    (sat_utils.py:226-256)."""
    gt_dsm_path = os.path.join(gt_dir, f"{aoi_id}_DSM.tif")
    cls_name = "CLS_v2" if aoi_id in ("JAX_004", "JAX_260") else "CLS"
    gt_seg_path = os.path.join(gt_dir, f"{aoi_id}_{cls_name}.tif")
    for path in (gt_dsm_path, gt_seg_path):
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path} not found")

    if "JAX" in aoi_id:
        gt_roi_path = os.path.join(gt_dir, f"{aoi_id}_DSM.txt")
        if not os.path.exists(gt_roi_path):
            raise FileNotFoundError(f"{gt_roi_path} not found")
        gt_roi_metadata = np.loadtxt(gt_roi_path)
    else:   # IARPA and others: the ROI from the GT raster's bounds (sat_utils.py:241-244)
        s = GeoTiffFile(gt_dsm_path)
        gt_roi_metadata = np.array([s.bounds.left, s.bounds.bottom, min(s.height, s.width),
                                    s.res[0]])

    rdsm_diff_path = os.path.join(out_dir, f"{src_id}_rdsm_diff_epoch{epoch_number}.tif")
    rdsm_path = os.path.join(out_dir, f"{src_id}_rdsm_epoch{epoch_number}.tif")
    os.makedirs(out_dir, exist_ok=True)
    diff = dsm_pointwise_diff(pred_dsm_path, gt_dsm_path, gt_roi_metadata,
                              gt_mask_path=gt_seg_path, out_rdsm_path=rdsm_path,
                              out_err_path=rdsm_diff_path)
    if not save:
        os.remove(rdsm_diff_path)
        os.remove(rdsm_path)
    return float(np.nanmean(np.abs(diff.ravel())))
