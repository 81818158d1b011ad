"""Virtual cameras for the DSM sweep (host numpy, as in the JAX package's
render/nadir.py; the reference's eval_eonerf.py:78-249), both branches:

- orthographic (the branch the reference uses): parallel rays along the
  view direction, origins on a plane perpendicular to it through a point
  ``radius`` above the scene origin (0, 0, -1), covering the [-1, 1]^2
  footprint; near = max(0, radius - 2), far = near + 2.5;
- pinhole (off in the reference, eval_eonerf.py:152,166-179): a
  perspective camera posed by ``pose_spherical(azimuth, elevation,
  radius)``, per-pixel directions from the focal length, one shared origin.

``enu_frame`` gives the local [east | north | up] basis of an ECEF scene,
into which both branches and the sun directions are rotated.
"""

import numpy as np


def dir_vec_from_el_az(elevation_deg, azimuth_deg):
    """Unit vector of incoming light (reference datasets/satellite.py:57-63):
    elevation 0 at nadir, 90 at frontal; it points from the sun TOWARD the
    ground."""
    el = np.radians(90 - elevation_deg)
    az = np.radians(azimuth_deg)
    return -1.0 * np.array([np.sin(az) * np.cos(el), np.cos(az) * np.cos(el), np.sin(el)])


def pose_spherical(theta_deg, phi_deg, radius):
    """Camera-to-world matrix at azimuth ``theta``, elevation ``phi``,
    distance ``radius`` (eval_eonerf.py:97-127)."""
    t, p = np.radians(theta_deg), np.radians(phi_deg)
    trans = np.eye(4)
    trans[2, 3] = radius
    rot_phi = np.array([[1, 0, 0, 0],
                        [0, np.cos(p), np.sin(p), 0],
                        [0, -np.sin(p), np.cos(p), 0],
                        [0, 0, 0, 1]])
    rot_theta = np.array([[np.cos(t), 0, -np.sin(t), 0],
                          [0, 1, 0, 0],
                          [np.sin(t), 0, np.cos(t), 0],
                          [0, 0, 0, 1]])
    return rot_theta @ rot_phi @ trans


def virtual_pinhole_rays(w, h, focal, radius=2.0, el_deg=0.0, az_deg=0.0, near=None, far=None,
                         pixel_center=0.5, frame=None):
    """(h*w, 8) float32 perspective ray tensor [o, d, near, far] in the
    normalized frame (eval_eonerf.py:166-179).

    The directions are normalized, so [near, far] is arc length for every
    pixel (the JAX package's documented deviation: the reference marches
    unnormalized directions in a branch it never runs). ``frame`` (see
    :func:`virtual_ortho_rays`) rotates origins and directions from the
    local z-up frame the pose is built in."""
    c2w = pose_spherical(az_deg, el_deg, radius)
    x, y = np.meshgrid(np.arange(w, dtype=np.float64) + pixel_center,
                       np.arange(h, dtype=np.float64) + pixel_center, indexing="xy")
    cam_dirs = np.stack([(x - w * 0.5) / focal, -(y - h * 0.5) / focal, -np.ones_like(x)],
                        axis=-1)
    dirs = (cam_dirs[..., None, :] * c2w[None, None, :3, :3]).sum(axis=-1)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.broadcast_to(c2w[:3, -1], dirs.shape)
    if frame is not None:
        frame = np.asarray(frame, np.float64)
        dirs = dirs @ frame.T
        origins = origins @ frame.T
    near = max(0.0, radius - 2.0) if near is None else near
    far = near + 2.5 if far is None else far
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    ones = np.ones((o.shape[0], 1))
    return np.hstack([o, d, near * ones, far * ones]).astype(np.float32)


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


def enu_frame(ecef_center):
    """Local [east | north | up] basis (columns) at an ECEF point: the frame
    in which el/az mean what they say inside an ECEF-normalized cube (the
    reference's ECEF prototype keeps z-up axes there). On the rotation axis,
    where east is undefined, east is taken as +y."""
    c = np.asarray(ecef_center, np.float64)
    u = c / np.linalg.norm(c)
    e = np.cross(np.array([0.0, 0.0, 1.0]), u)
    e_norm = np.linalg.norm(e)
    e = np.array([0.0, 1.0, 0.0]) if e_norm < 1e-9 else e / e_norm
    n = np.cross(u, e)
    return np.stack([e, n, u], axis=1)


def nadir_rays_with_sun(w, h, sun_el_deg, sun_az_deg, scene_scale, img_downscale=1.0,
                        radius=2.0, pinhole=False, frame=None):
    """(h*w, 11) float32 nadir ray tensor with sun directions
    (eval_eonerf.py:78-95), and the downscaled (h, w). ``pinhole`` takes the
    perspective branch with the reference's focal, max(h, w) //
    img_downscale of the already downscaled h and w (eval_eonerf.py:85)."""
    h = int(h // img_downscale)
    w = int(w // img_downscale)
    if pinhole:
        rays = virtual_pinhole_rays(w, h, max(h, w) // img_downscale, radius=radius, frame=frame)
    else:
        rays = virtual_ortho_rays(w, h, radius=radius, scene_scale=scene_scale, frame=frame)
    sun_d = dir_vec_from_el_az(sun_el_deg, sun_az_deg)
    if frame is not None:
        sun_d = np.asarray(frame, np.float64) @ sun_d
    sun_d = sun_d / np.asarray(scene_scale, np.float64)
    sun_d = sun_d / np.linalg.norm(sun_d)
    sun = np.tile(sun_d, (rays.shape[0], 1)).astype(np.float32)
    return np.hstack([rays, sun]).astype(np.float32), h, w
