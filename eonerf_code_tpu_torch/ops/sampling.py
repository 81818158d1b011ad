"""Ray sampling on dense (rays, samples) blocks.

Fixed-count uniform-in-depth sampling on [near, far] with stratified
jitter (reference sat_rendering.py:46-84); out-of-cube samples are kept and
masked, which is algebraically identical to the reference's point removal
for transmittance and weights. The reference perturbs in eval too.
``sample_pdf`` draws the hierarchical sampler's fine samples from the
coarse weights.

Every draw goes through :func:`uniform`, which also takes a
:class:`RowShare` (the generator of a data-parallel step, held in step on
every rank) or a :class:`DrawLog` (which records a render's draws, so that
a rank can skip the draws of the blocks before its own).
"""

import torch


class RowShare:
    """A generator that the ranks of a data axis hold in step. Each draw is
    made at the global batch's shape (this rank's rows times ``world``) and
    the rank keeps its own contiguous rows, so a world-N step samples the
    z values of the world-1 step on the same global batch (the JAX mesh
    step's draws), no two ranks draw the same noise, and the generators
    stay equal for the draws that are not per ray (the epoch permutation,
    the occupancy probes)."""

    def __init__(self, generator, rank, world):
        self.generator = generator
        self.rank = rank
        self.world = world


class DrawLog:
    """A generator stand-in that draws from ``generator`` and records each
    draw's shape past its rows, and its dtype: every draw of a render has
    one row a ray, so a one-ray render's log gives the draws of a render of
    any number of rays (:func:`skip_draws`)."""

    def __init__(self, generator):
        self.generator = generator
        self.draws = []


def skip_draws(draws, rows, device, generator=None):
    """Advance ``generator`` as a render of ``rows`` rays that makes
    ``draws`` (a :class:`DrawLog`'s) does."""
    for tail, dtype in draws:
        torch.rand((rows, *tail), dtype=dtype, device=device, generator=generator)


def uniform(shape, dtype, device, generator=None):
    """``torch.rand(shape)`` from ``generator``; with a :class:`RowShare`,
    this rank's rows of the global draw (``shape[0]`` rows a rank); with a
    :class:`DrawLog`, recorded."""
    if isinstance(generator, DrawLog):
        generator.draws.append((tuple(shape[1:]), dtype))
        generator = generator.generator
    if isinstance(generator, RowShare):
        rows = shape[0]
        u = torch.rand((rows * generator.world, *shape[1:]), dtype=dtype, device=device,
                       generator=generator.generator)
        return u[generator.rank * rows:(generator.rank + 1) * rows]
    return torch.rand(shape, dtype=dtype, device=device, generator=generator)


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
        u = uniform(z_vals.shape, z_vals.dtype, z_vals.device, generator)
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
        u = uniform((r, n_importance), bins.dtype, bins.device, generator)
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
