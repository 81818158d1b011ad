"""Ray sampling on dense (rays, samples) blocks.

Fixed-count uniform-in-depth sampling on [near, far] with stratified
jitter (reference sat_rendering.py:46-84); out-of-cube samples are kept and
masked, which is algebraically identical to the reference's point removal
for transmittance and weights. The reference perturbs in eval too.
Hierarchical ``sample_pdf`` arrives with the hierarchical-sampling slice.
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
