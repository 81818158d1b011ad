"""Point cloud -> DSM rasterisation on the device (plyflatten-equivalent).

The reference rasterises with plyflatten (radius=1, sigma=inf,
datasets/satellite.py:580-587): every point adds its altitude with uniform
weight to all cells within a Chebyshev radius of 1 cell of its own, and a
cell holds the mean of its contributions (NaN if none). Scatter-add with
``index_add_`` over linearised cell indices (the JAX package uses
``segment_sum``).
"""

import torch


def rasterize_pointcloud(easts, norths, alts, xoff, yoff, resolution, xsize, ysize,
                         radius=1):
    """(ysize, xsize) mean-splat DSM of the points, NaN where empty, in the
    dtype of ``alts`` (float32 or float64) on its device."""
    cols = torch.floor((easts - xoff) / resolution).to(torch.int64)
    rows = torch.floor((yoff - norths) / resolution).to(torch.int64)
    n_cells = xsize * ysize
    acc = torch.zeros(n_cells, dtype=alts.dtype, device=alts.device)
    cnt = torch.zeros(n_cells, dtype=torch.int64, device=alts.device)
    for dr in range(-radius, radius + 1):
        for dc in range(-radius, radius + 1):
            r = rows + dr
            c = cols + dc
            ok = (r >= 0) & (r < ysize) & (c >= 0) & (c < xsize)
            lin = (r * xsize + c)[ok]
            acc.index_add_(0, lin, alts[ok])
            cnt.index_add_(0, lin, torch.ones_like(lin))
    dsm = torch.where(cnt > 0, acc / cnt.clamp(min=1), torch.full_like(acc, float("nan")))
    return dsm.reshape(ysize, xsize)
