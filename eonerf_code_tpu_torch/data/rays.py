"""The (N, 11) satellite ray tensor and its structured view.

Column layout (shared with the reference, datasets/satellite.py:412-417):

    columns 0:3   ray origin (scene-normalized)
    columns 3:6   unit direction vector
    column  6     near bound
    column  7     far bound
    columns 8:11  unit sun direction
"""

from typing import Any, NamedTuple

RAY_TENSOR_WIDTH = 11


class SatRays(NamedTuple):
    origins: Any   # (R, 3)
    viewdirs: Any  # (R, 3)
    sundirs: Any   # (R, 3)
    img_idx: Any   # (R,) int64
    t_near: Any    # (R,)
    t_far: Any     # (R,)

    @property
    def num_rays(self):
        return self.origins.shape[0]


def satrays_from_tensor(rays, ts):
    """(N, 11) float tensor + (N,) or (N, 1) image indices -> SatRays
    (reference datasets/satellite.py:23-26)."""
    return SatRays(
        origins=rays[:, 0:3],
        viewdirs=rays[:, 3:6],
        sundirs=rays[:, 8:11],
        img_idx=ts.reshape(-1).long(),
        t_near=rays[:, 6],
        t_far=rays[:, 7],
    )
