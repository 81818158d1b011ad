"""Losses and metrics (reference: metrics.py), as the JAX package's
utils/metrics.py. Each loss returns (scalar, dict) with the keys the
reference logs (coarse_color, coarse_logbeta, depth_l2, shadows_term1, ...).

Data parallel: each loss is one rank's share of the global batch's loss
(``world`` ranks over equal shards of one global batch). A mean over the
rank's rows is divided by ``world``; a masked sum is divided by the global
batch's count, which the caller takes from the global batch (``n_valid``,
``counts``; the shadow loss's default to this batch's). The shares sum
to the single-process loss and their gradients to its gradient; an
average of per-rank means would not, where the shards' valid counts
differ. At world 1 every loss is the single process's, to the bit
(dividing by 1 is exact)."""

import torch


def uncertainty_aware_loss(gt_rgb, pred_rgb, pred_beta, world=1):
    """NeRF-W / SatNeRF beta loss (metrics.py:17-22):
    ||drgb||^2 / (2 beta^2) + (3 + mean log beta) / 2."""
    color_term = torch.mean((pred_rgb - gt_rgb) ** 2 / (2.0 * pred_beta ** 2)) / world
    beta_term = (3.0 + torch.mean(torch.log(pred_beta))) / 2.0 / world
    loss = color_term + beta_term
    return loss, {"loss": loss, "coarse_color": color_term, "coarse_logbeta": beta_term}


def depth_valid(gt_depth, gt_conf=None):
    """Where the depth prior counts: gt_depth >= 0 and (if given) SGM
    confidence >= 4."""
    valid = gt_depth >= 0
    if gt_conf is not None:
        valid = valid & (gt_conf >= 4)
    return valid


def depth_loss_l2(gt_depth, pred_depth, gt_conf, w, n_valid):
    """Masked depth-prior L2 (metrics.py:24-31) over :func:`depth_valid`,
    divided by ``n_valid`` valid rays, scaled by w."""
    valid = depth_valid(gt_depth, gt_conf)
    term = torch.where(valid, (pred_depth - gt_depth) ** 2, 0.0).sum() / n_valid.clamp(min=1)
    term = term * w
    return term, {"depth_l2": term, "depth_weight": w}


def differentiable_thresholding(x, thr=0.5):
    """Soft step sigmoid(100 (x - thr)) (metrics.py:33-34)."""
    return 1.0 / (1.0 + torch.exp(-100.0 * (x - thr)))


def shadow_counts(smask):
    """The shadow loss's counts: rays the prior marks in shadow, rays it
    covers."""
    return (smask <= 0.5).sum(), (smask >= 0).sum()


def shadow_loss_l2(smask, geo_shadows, counts=None, world=1):
    """Shadow-prior loss (metrics.py:36-58): penalize rendered sun visibility
    where the prior mask says shadow (smask <= 0.5), weighted by the GT
    shadow fraction; ``counts``: :func:`shadow_counts` (default: this
    batch's)."""
    in_shadow = smask <= 0.5
    n_shadow, n_prior = shadow_counts(smask) if counts is None else counts
    diff = torch.where(in_shadow, (geo_shadows - smask) ** 2, 0.0)
    mean_diff = diff.sum() / (n_shadow + 1e-6)
    frac = n_shadow / n_prior.clamp(min=1)
    term = frac * mean_diff
    penalized = ((geo_shadows > 0.2) & (smask < 0.5)).float().mean() / world
    return term, {"shadows_term1": term, "shadow_vals_to_penalize": penalized}


def mse(pred, gt, valid_mask=None, world=1):
    v = (pred - gt) ** 2
    if valid_mask is not None:
        return torch.where(valid_mask, v, 0.0).sum() / valid_mask.sum().clamp(min=1)
    return v.mean() / world


def psnr_of(mse_value):
    return -10.0 * torch.log10(mse_value)


def psnr(pred, gt, valid_mask=None):
    return psnr_of(mse(pred, gt, valid_mask))
