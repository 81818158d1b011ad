"""View roster helpers: sort scenes' json metadata by viewing geometry,
solar geometry or acquisition date (reference: sat_utils.py:262-308), plus
the shadow-coverage ordering used by --subset_Nviews with shadow masks
(datasets/satellite.py:266-271)."""

import datetime
import glob
import json
import os

import numpy as np

from eonerf_code_tpu_torch.geo import RPCModel


def _json_paths(root_dir):
    return sorted(glob.glob(os.path.join(root_dir, "*.json")))


def sort_by_increasing_view_incidence_angle(root_dir):
    """Most-nadir view first (sat_utils.py:262-272)."""
    out = []
    for json_p in _json_paths(root_dir):
        with open(json_p) as f:
            d = json.load(f)
        rpc = RPCModel(d["rpc"])
        lon, lat = d["geojson"]["center"][0], d["geojson"]["center"][1]
        zen, _ = rpc.incidence_angles(lon, lat, z=0.0)
        out.append((zen, json_p))
    return [p for _, p in sorted(out)]


def sort_by_increasing_solar_incidence_angle(root_dir):
    """Highest sun first (sat_utils.py:274-288)."""
    out = []
    for json_p in _json_paths(root_dir):
        with open(json_p) as f:
            d = json.load(f)
        el = np.radians(float(d["sun_elevation"]))
        az = np.radians(float(d["sun_azimuth"]))
        sun = np.array([np.sin(az) * np.cos(el), np.cos(az) * np.cos(el), np.sin(el)])
        alpha = np.degrees(np.arccos(np.clip(sun[2] / np.linalg.norm(sun), -1, 1)))
        out.append((alpha, json_p))
    return [p for _, p in sorted(out)]


def sort_by_acquisition_date(root_dir):
    out = []
    for json_p in _json_paths(root_dir):
        with open(json_p) as f:
            d = json.load(f)
        out.append((datetime.datetime.strptime(d["acquisition_date"], "%Y%m%d%H%M%S"), json_p))
    return [p for _, p in sorted(out)]


def sort_by_day_of_the_year(root_dir):
    out = []
    for json_p in _json_paths(root_dir):
        with open(json_p) as f:
            d = json.load(f)
        dt = datetime.datetime.strptime(d["acquisition_date"], "%Y%m%d%H%M%S")
        out.append((dt.timetuple().tm_yday, json_p))
    return [p for _, p in sorted(out, key=lambda x: x[0])]


def sort_from_more_shadows_to_less_shadows(shadow_mask_vectors):
    """Indices ordered by decreasing shadow coverage (zero count)
    (datasets/satellite.py:266-271)."""
    zero_counts = [int(np.sum(np.asarray(v) == 0)) for v in shadow_mask_vectors]
    return np.argsort(zero_counts)[::-1].tolist()
