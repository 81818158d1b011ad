"""Ray sampling on dense (rays, samples) blocks.

Fixed-count uniform-in-depth sampling on [near, far] with stratified
jitter (reference sat_rendering.py:46-84); out-of-cube samples are kept and
masked, which is algebraically identical to the reference's point removal
for transmittance and weights. The reference perturbs in eval too.
``sample_pdf`` draws the hierarchical sampler's fine samples from the
coarse weights.
"""

import torch


def perturb_z_vals(z_vals, u):
    """Stratified jitter inside the midpoint intervals
    (sat_rendering.py:46-54). ``u`` is uniform noise of z_vals' shape."""
    mids = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
    upper = torch.cat([mids, z_vals[:, -1:]], dim=-1)
    lower = torch.cat([z_vals[:, :1], mids], dim=-1)
    return lower + (upper - lower) * u


def linear_z_vals(near, far, n_samples):
    """(R, n_samples) evenly spaced z on [near, far]; near/far (R,) or (R, 1)."""
    near = near.reshape(-1, 1)
    far = far.reshape(-1, 1)
    steps = torch.linspace(0.0, 1.0, n_samples, dtype=near.dtype, device=near.device)
    return near * (1.0 - steps) + far * steps


def stratified_z_vals(near, far, n_samples, perturb=True, generator=None):
    """Uniform-in-depth z values (R, n_samples) on [near, far] per ray,
    jittered with noise drawn from ``generator`` when ``perturb``."""
    z_vals = linear_z_vals(near, far, n_samples)
    if perturb:
        u = torch.rand(z_vals.shape, dtype=z_vals.dtype, device=z_vals.device,
                       generator=generator)
        z_vals = perturb_z_vals(z_vals, u)
    return z_vals


def sample_pdf(bins, weights, n_importance, perturb=True, generator=None, eps=1e-5):
    """Inverse-CDF draws of ``n_importance`` z values per ray from the
    piecewise-constant PDF of ``weights`` (R, K) over the interval edges
    ``bins`` (R, K+1); unsorted (R, n_importance). ``perturb=False`` draws
    at linspace(0, 1 - 1e-6), else uniform noise from ``generator``
    (the JAX package's ops/sampling.py:56-92)."""
    weights = weights + eps   # no NaN on an empty ray
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, dim=-1)], dim=-1)
    r = bins.shape[0]
    if perturb:
        u = torch.rand((r, n_importance), dtype=bins.dtype, device=bins.device,
                       generator=generator)
    else:
        u = torch.linspace(0.0, 1.0 - 1e-6, n_importance, dtype=bins.dtype,
                           device=bins.device).expand(r, n_importance).contiguous()
    idx = torch.searchsorted(cdf, u, right=True)
    below = (idx - 1).clamp(0, cdf.shape[-1] - 1)
    above = idx.clamp(0, cdf.shape[-1] - 1)
    cdf_lo, cdf_hi = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bin_lo = torch.gather(bins, -1, below.clamp(max=bins.shape[-1] - 1))
    bin_hi = torch.gather(bins, -1, above.clamp(max=bins.shape[-1] - 1))
    denom = torch.where(cdf_hi - cdf_lo < eps, torch.ones_like(cdf_hi), cdf_hi - cdf_lo)
    return bin_lo + (u - cdf_lo) / denom * (bin_hi - bin_lo)


def intervals_from_z(z_vals):
    """z (R, S) -> (t_starts, t_ends, z_mid, delta), each (R, S-1): t_start
    = z_i, t_end = z_{i+1}, sample position at the midpoint."""
    t_starts = z_vals[:, :-1]
    t_ends = z_vals[:, 1:]
    z_mid = 0.5 * (t_starts + t_ends)
    return t_starts, t_ends, z_mid, t_ends - t_starts


def cube_mask(xyz, bound=1.0):
    """True where the point is strictly inside [-bound, bound]^3
    (sat_rendering.py:18-22)."""
    return (xyz.abs() < bound).all(dim=-1)


def set_last_valid(delta, mask, value=1e10):
    """Set delta to ``value`` at the LAST valid sample of each ray (the
    reference's ``t_ends[last_pt_of_ray] = 1e10``, eonerf.py:218-220). A ray
    with no valid sample gets it at its last sample, where its density is
    masked to zero anyway."""
    k = mask.shape[-1]
    last_idx = k - 1 - torch.argmax(mask.flip(-1).to(torch.int32), dim=-1)
    onehot = torch.arange(k, device=mask.device) == last_idx[:, None]
    return torch.where(onehot, torch.full_like(delta, value), delta)
