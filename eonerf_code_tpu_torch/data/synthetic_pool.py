"""A seeded ray pool in the trainer's layout, made on the device: for
driving and timing the training step where no dataset is at hand (the
dataset loader arrives with the data-and-eval slice)."""

import math

import torch


def synthetic_ray_pool(n, n_views, device="cuda", seed=7):
    """{"rays" (n, 11), "rgbs" (n, 3), "ts" (n,)}: rays from the top face of
    the [-1, 1]^3 cube, n / n_views per view; each view looks within 20
    degrees of nadir and has its own sun direction, 30-55 degrees from the
    zenith; rgb uniform in [0, 1]. Not a scene: the colours carry no
    geometry, so the pool drives the step but teaches the field nothing."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(*shape):
        return torch.rand(shape, generator=g, device=dev)

    ts = torch.arange(n, device=dev) % n_views
    tilt, az = torch.deg2rad(20.0 * u(n_views)), 2 * math.pi * u(n_views)
    view = torch.stack([tilt.sin() * az.cos(), tilt.sin() * az.sin(), -tilt.cos()], dim=1)
    zen, saz = torch.deg2rad(30.0 + 25.0 * u(n_views)), 2 * math.pi * u(n_views)
    sun = torch.stack([zen.sin() * saz.cos(), zen.sin() * saz.sin(), -zen.cos()], dim=1)
    origin = torch.cat([(2 * u(n, 2) - 1) * 0.8, torch.full((n, 1), 0.99, device=dev)], dim=1)
    rays = torch.cat([origin, view[ts], torch.zeros((n, 1), device=dev),
                      torch.full((n, 1), 2.0, device=dev), sun[ts]], dim=1)
    return {"rays": rays, "rgbs": u(n, 3), "ts": ts}
