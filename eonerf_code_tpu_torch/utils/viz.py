"""Visualization helpers (reference: utils.py:156-167 `visualize_depth`)."""

import numpy as np


def visualize_depth(depth, vmin=None, vmax=None):
    """(h, w) depth -> (h, w, 3) turbo-ish colormap in [0, 1], NaN-safe."""
    d = np.asarray(depth, np.float64).copy()
    finite = np.isfinite(d)
    if not finite.any():
        return np.zeros((*d.shape, 3), np.float32)
    lo = np.min(d[finite]) if vmin is None else vmin
    hi = np.max(d[finite]) if vmax is None else vmax
    x = np.clip((d - lo) / max(hi - lo, 1e-9), 0, 1)
    x = np.where(finite, x, 0.0)
    # compact 4-stop colormap: dark blue -> cyan -> yellow -> red
    stops = np.array([[0.05, 0.05, 0.4], [0.0, 0.8, 0.9],
                      [0.95, 0.9, 0.1], [0.85, 0.1, 0.05]])
    seg = np.clip(x * 3.0, 0, 3.0 - 1e-9)
    i = seg.astype(int)
    f = (seg - i)[..., None]
    rgb = stops[i] * (1 - f) + stops[i + 1] * f
    rgb[~finite] = 0.0
    return rgb.astype(np.float32)
