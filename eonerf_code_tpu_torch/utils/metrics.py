"""Losses and metrics (reference: metrics.py), as the JAX package's
utils/metrics.py. Each loss returns (scalar, dict) with the keys the
reference logs (coarse_color, coarse_logbeta, depth_l2, shadows_term1, ...)."""

import torch


def uncertainty_aware_loss(gt_rgb, pred_rgb, pred_beta):
    """NeRF-W / SatNeRF beta loss (metrics.py:17-22):
    ||drgb||^2 / (2 beta^2) + (3 + mean log beta) / 2."""
    color_term = torch.mean((pred_rgb - gt_rgb) ** 2 / (2.0 * pred_beta ** 2))
    beta_term = (3.0 + torch.mean(torch.log(pred_beta))) / 2.0
    loss = color_term + beta_term
    return loss, {"loss": loss, "coarse_color": color_term, "coarse_logbeta": beta_term}


def depth_loss_l2(gt_depth, pred_depth, gt_conf=None, w=100.0):
    """Masked depth-prior L2 (metrics.py:24-31): valid where gt_depth >= 0
    and (if given) SGM confidence >= 4; scaled by w."""
    valid = gt_depth >= 0
    if gt_conf is not None:
        valid = valid & (gt_conf >= 4)
    n = valid.sum().clamp(min=1)
    term = torch.where(valid, (pred_depth - gt_depth) ** 2, 0.0).sum() / n
    term = term * w
    return term, {"depth_l2": term, "depth_weight": w}


def differentiable_thresholding(x, thr=0.5):
    """Soft step sigmoid(100 (x - thr)) (metrics.py:33-34)."""
    return 1.0 / (1.0 + torch.exp(-100.0 * (x - thr)))


def shadow_loss_l2(smask, geo_shadows):
    """Shadow-prior loss (metrics.py:36-58): penalize rendered sun visibility
    where the prior mask says shadow (smask <= 0.5), weighted by the GT
    shadow fraction."""
    in_shadow = smask <= 0.5
    diff = torch.where(in_shadow, (geo_shadows - smask) ** 2, 0.0)
    mean_diff = diff.sum() / (in_shadow.sum() + 1e-6)
    frac = in_shadow.sum() / (smask >= 0).sum().clamp(min=1)
    term = frac * mean_diff
    penalized = ((geo_shadows > 0.2) & (smask < 0.5)).float().mean()
    return term, {"shadows_term1": term, "shadow_vals_to_penalize": penalized}


def mse(pred, gt, valid_mask=None):
    v = (pred - gt) ** 2
    if valid_mask is not None:
        return torch.where(valid_mask, v, 0.0).sum() / valid_mask.sum().clamp(min=1)
    return v.mean()


def psnr(pred, gt, valid_mask=None):
    return -10.0 * torch.log10(mse(pred, gt, valid_mask))
