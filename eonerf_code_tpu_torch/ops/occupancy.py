"""Binary occupancy grid over the [-1, 1]^3 scene cube (the JAX package's
ops/occupancy.py, nerfacc's ``OccGridEstimator`` semantics).

A dense float occupancy buffer with EMA-max updates from jittered density
probes, thresholded into a binary grid. The trainer keeps it up to date
every ``occ_update_every`` steps; the renderer uses it either to tighten
each ray's sample range to its occupied span (``RenderConfig.occ_tighten``)
or, without tightening, as an empty-space mask.

Updates return a new grid (as the JAX package's functional update); the
random draws come from an explicit ``torch.Generator`` or are handed in
(``idx`` / ``u``), which is how the tests feed both packages the same
draws.
"""

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class OccupancyGrid:
    occs: torch.Tensor       # (res^3,) float32 EMA occupancy
    binaries: torch.Tensor   # (res, res, res) bool
    resolution: int
    aabb_min: float = -1.0
    aabb_max: float = 1.0

    @classmethod
    def create(cls, resolution=128, device="cuda"):
        return cls(occs=torch.zeros((resolution ** 3,), dtype=torch.float32, device=device),
                   binaries=torch.zeros((resolution,) * 3, dtype=torch.bool, device=device),
                   resolution=resolution)

    def cell_size(self):
        return (self.aabb_max - self.aabb_min) / self.resolution

    def update(self, density_fn, render_step_size, ema_decay=0.95, occ_thre=1e-2,
               max_cells=None, generator=None, idx=None, u=None):
        """One occupancy update: probe a jittered point in each of
        ``max_cells`` random cells (all cells when None), occupancy
        ~ sigma * render_step_size, EMA-max into ``occs``, threshold at
        min(mean(occs), occ_thre). ``density_fn`` maps (N, 3) -> (N,).

        A cell drawn twice in one update keeps its LAST draw's value, as a
        sequential scatter gives (the JAX package's on the CPU); resolved
        explicitly here because the card's scatter order is undefined."""
        res = self.resolution
        n = res ** 3
        dev = self.occs.device
        if idx is None:
            if max_cells is not None and max_cells < n:
                idx = torch.randint(0, n, (max_cells,), generator=generator, device=dev)
            else:
                idx = torch.arange(n, device=dev)
        if u is None:
            u = torch.rand((idx.shape[0], 3), generator=generator, device=dev)
        ijk = torch.stack([idx // (res * res), (idx // res) % res, idx % res], dim=-1)
        xyz = self.aabb_min + (ijk.float() + u) * self.cell_size()
        occ = density_fn(xyz).float() * render_step_size
        new_vals = torch.maximum(self.occs[idx] * ema_decay, occ)
        keep = _last_of_each_index(idx)
        occs = self.occs.clone()
        occs[idx[keep]] = new_vals[keep]
        thre = torch.clamp(occs.mean(), max=occ_thre)
        return dataclasses.replace(self, occs=occs, binaries=(occs > thre).reshape(res, res, res))

    def query(self, xyz):
        """True where xyz falls in an occupied cell. (..., 3) -> (...)."""
        res = self.resolution
        ijk = ((xyz - self.aabb_min) / self.cell_size()).to(torch.int32).clamp(0, res - 1).long()
        return self.binaries[ijk[..., 0], ijk[..., 1], ijk[..., 2]]

    def ray_span(self, origins, dirs, near, far, n_probes=64, margin=2.0):
        """Per-ray tightened sample range (t_lo, t_hi), each (R,): the first
        and last occupied of ``n_probes`` fixed probes on [near, far],
        widened by ``margin`` probe spacings and clipped to [near, far];
        rays that hit no occupied cell keep [near, far]. origins/dirs
        (R, 3); near (R,); far (R,) or a scalar."""
        near = near.reshape(-1)
        far = torch.broadcast_to(torch.as_tensor(far, dtype=near.dtype, device=near.device),
                                 near.shape).reshape(-1)
        dt = (far - near) / n_probes
        ts = near[:, None] + (torch.arange(n_probes, dtype=near.dtype, device=near.device)
                              + 0.5) * dt[:, None]
        pos = origins[:, None, :] + dirs[:, None, :] * ts[..., None]
        inside = ((pos > self.aabb_min) & (pos < self.aabb_max)).all(dim=-1)
        occ = self.query(pos) & inside
        any_occ = occ.any(dim=-1)
        inf = torch.full_like(ts, float("inf"))
        t_lo = torch.where(occ, ts, inf).amin(dim=-1) - margin * dt
        t_hi = torch.where(occ, ts, -inf).amax(dim=-1) + margin * dt
        t_lo = torch.where(any_occ, torch.maximum(t_lo, near), near)
        t_hi = torch.where(any_occ, torch.minimum(t_hi, far), far)
        return t_lo, t_hi


def _last_of_each_index(idx):
    """Boolean mask over ``idx`` (1-D): True at the last occurrence of each
    value."""
    order = torch.sort(idx, stable=True).indices
    sorted_idx = idx[order]
    last_sorted = torch.ones_like(sorted_idx, dtype=torch.bool)
    last_sorted[:-1] = sorted_idx[1:] != sorted_idx[:-1]
    keep = torch.zeros_like(last_sorted)
    keep[order] = last_sorted
    return keep
