"""Virtual nadir camera for the DSM sweep (host numpy, as in the JAX
package's render/nadir.py; the reference's eval_eonerf.py:78-249).

Orthographic branch only (the one the reference uses): parallel rays along
the view direction, origins on a plane perpendicular to it through a point
``radius`` above the scene origin (0, 0, -1), covering the [-1, 1]^2
footprint; near = max(0, radius - 2), far = near + 2.5. The pinhole branch
(off in the reference) is left for a later slice.
"""

import numpy as np


def dir_vec_from_el_az(elevation_deg, azimuth_deg):
    """Unit vector of incoming light (reference datasets/satellite.py:57-63):
    elevation 0 at nadir, 90 at frontal; it points from the sun TOWARD the
    ground."""
    el = np.radians(90 - elevation_deg)
    az = np.radians(azimuth_deg)
    return -1.0 * np.array([np.sin(az) * np.cos(el), np.cos(az) * np.cos(el), np.sin(el)])


def virtual_ortho_rays(w, h, radius=2.0, el_deg=0.0, az_deg=0.0, scene_scale=np.ones(3),
                       frame=None):
    """(h*w, 8) float32 ray tensor [o, d, near, far] in the normalized frame.

    ``frame``: 3x3 with COLUMNS [east, north, up] in the scene's world axes —
    None (identity) for UTM scenes, the local ENU basis at the scene centre
    for ECEF scenes. With frame=None this is the reference's z-up
    construction (eval_eonerf.py:130-249)."""
    d_enu = dir_vec_from_el_az(el_deg, az_deg).astype(np.float64)
    if frame is None:
        e_ax = np.array([1.0, 0.0, 0.0])
        n_ax = np.array([0.0, 1.0, 0.0])
        u_ax = np.array([0.0, 0.0, 1.0])
        d = d_enu
    else:
        frame = np.asarray(frame, np.float64)
        e_ax, n_ax, u_ax = frame[:, 0], frame[:, 1], frame[:, 2]
        d = frame @ d_enu
    d = d / np.asarray(scene_scale, np.float64)
    d = d / np.linalg.norm(d)

    pt_o = -u_ax                   # "bottom" of the scene cube along local up
    pt_a = pt_o - radius * d       # centre of the virtual image plane

    x = (np.arange(w) - w * 0.5) / (1.0 * w / radius)
    y = -(np.arange(h) - h * 0.5) / (1.0 * h / radius)
    X, Y = np.meshgrid(x, y)
    # each origin's up-coordinate solves d . (origin - pt_a) = 0: the
    # reference's slanted image plane through pt_a, in ENU components
    du, de, dn = d @ u_ax, d @ e_ax, d @ n_ax
    U = (-de * X - dn * Y) / du
    origins = (pt_a[None, :]
               + X.ravel()[:, None] * e_ax[None, :]
               + Y.ravel()[:, None] * n_ax[None, :]
               + U.ravel()[:, None] * u_ax[None, :])

    dirs = np.tile(d, (origins.shape[0], 1))
    near = max(0.0, radius - 2.0)
    far = near + 2.5
    ones = np.ones((origins.shape[0], 1))
    return np.hstack([origins, dirs, near * ones, far * ones]).astype(np.float32)


def nadir_rays_with_sun(w, h, sun_el_deg, sun_az_deg, scene_scale, img_downscale=1.0,
                        radius=2.0, frame=None):
    """(h*w, 11) float32 nadir ray tensor with sun directions
    (eval_eonerf.py:78-95), and the downscaled (h, w)."""
    h = int(h // img_downscale)
    w = int(w // img_downscale)
    rays = virtual_ortho_rays(w, h, radius=radius, scene_scale=scene_scale, frame=frame)
    sun_d = dir_vec_from_el_az(sun_el_deg, sun_az_deg)
    if frame is not None:
        sun_d = np.asarray(frame, np.float64) @ sun_d
    sun_d = sun_d / np.asarray(scene_scale, np.float64)
    sun_d = sun_d / np.linalg.norm(sun_d)
    sun = np.tile(sun_d, (rays.shape[0], 1)).astype(np.float32)
    return np.hstack([rays, sun]).astype(np.float32), h, w
