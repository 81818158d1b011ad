"""Vanilla-NeRF training on a nerf_synthetic subject, as the JAX package's
train/train_vanilla.py (the working form of the reference's
train_mlp_nerf.py): an occupancy-grid NeRF, the Huber loss, Adam with the
learning rate cut to 0.33 of itself at 1/2, 3/4 and 9/10 of the run. The
ray batch is fixed and the grid masks empty samples (the reference resizes
its batch toward a sample budget instead); the count of samples the grid
keeps is logged.

Runs on the card unless the caller passes ``device="cpu"``; without a card
``device="cuda"`` raises. Every draw comes from an explicit generator.
"""

import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from eonerf_code_tpu_torch.data.nerf_synthetic import BlenderDataset
from eonerf_code_tpu_torch.models.vanilla import VanillaNeRF
from eonerf_code_tpu_torch.ops.occupancy import OccupancyGrid
from eonerf_code_tpu_torch.render.blender import BlenderRenderConfig, render_blender_rays
from eonerf_code_tpu_torch.utils import metrics as M
from eonerf_code_tpu_torch.utils.tb import MetricsLogger

# the reference's occupancy aabb, [-1.5, 1.5]^3 (train_mlp_nerf.py:96)
GRID_AABB = 1.5


def lr_boundaries(max_steps):
    """The schedule's {step: scale}. Keys collapse when ``max_steps`` is
    small (3 gives {1, 2}), as the JAX package's dict does."""
    return {max_steps // 2: 0.33, max_steps * 3 // 4: 0.33, max_steps * 9 // 10: 0.33}


def learning_rate(lr, max_steps, count):
    """``optax.piecewise_constant_schedule(lr, lr_boundaries(max_steps))``
    after ``count`` updates, in float32 as optax computes it: each scale
    applies from the update whose count equals its boundary."""
    v = np.float32(lr)
    for boundary, scale in sorted(lr_boundaries(max_steps).items()):
        if count >= boundary:
            v = np.float32(scale) * v
    return float(v)


def resolve_device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the vanilla path runs on the card; pass "
                           "device='cpu' to run it on the host")
    return device


def make_grid(resolution, device):
    """The training grid: occupancy 0, every cell open."""
    return OccupancyGrid(occs=torch.zeros((resolution ** 3,), dtype=torch.float32, device=device),
                         binaries=torch.ones((resolution,) * 3, dtype=torch.bool, device=device),
                         resolution=resolution, aabb_min=-GRID_AABB, aabb_max=GRID_AABB)


def make_optimizer(model, lr):
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def batch_to(batch, device):
    """A ``BlenderDataset`` batch (numpy) as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def occ_update(model, grid, rcfg, generator=None, u=None):
    """One whole-grid update from the model's density, the probe jitter
    ``u`` (res^3, 3) or drawn from ``generator``; occupancy is sigma times
    the render step (far - near) / (n_samples - 1)."""
    render_step = (rcfg.far - rcfg.near) / (rcfg.n_samples - 1)
    with torch.no_grad():
        return grid.update(model.density, render_step, generator=generator, u=u)


def train_step(model, optimizer, grid, batch, rcfg, lr, generator=None, u=None):
    """One Adam step at learning rate ``lr`` on the Huber loss (delta 1,
    mean) of ``batch`` (tensors) rendered through ``grid``; the jitter
    ``u`` or drawn from ``generator``. Returns (loss, n_eff_samples) as
    tensors on the device."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    out = render_blender_rays(model, batch["rays_o"], batch["rays_d"], batch["color_bkgd"],
                              rcfg, occ_grid=grid, generator=generator, u=u)
    loss = F.huber_loss(out["rgb"], batch["pixels"].to(out["rgb"].dtype), delta=1.0)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach(), out["n_eff_samples"]


def train_vanilla(subject_id="lego", root_fp="data/nerf_synthetic", logs_dir="logs",
                  max_steps=50000, batch_size=4096, lr=5e-4, n_samples=129,
                  grid_resolution=64, occ_every=16, log_every=100, seed=42,
                  net_depth=8, net_width=256, train_split="train", device="cuda",
                  generator=None):
    """Train a VanillaNeRF (weights drawn from ``seed``) on ``subject_id``.
    The whole grid is updated before the batch of every step with ``step %
    occ_every == 0``. ``generator`` (on ``device``; default seeded with
    ``seed``) gives the grid's probes and the sample jitter. Returns
    dict(params (the model's state), grid, model, rcfg, dataset,
    elapsed_s)."""
    device = resolve_device(device)
    ds = BlenderDataset(subject_id, root_fp, split=train_split, num_rays=batch_size, seed=seed)
    model = VanillaNeRF(net_depth=net_depth, net_width=net_width, device=device,
                        generator=torch.Generator().manual_seed(seed))
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    optimizer = make_optimizer(model, lr)
    grid = make_grid(grid_resolution, device)
    rcfg = BlenderRenderConfig(n_samples=n_samples)

    logger = MetricsLogger(os.path.join(logs_dir, f"vanilla_{subject_id}"))
    tic = time.time()
    try:
        for step in range(max_steps):
            if step % occ_every == 0:
                grid = occ_update(model, grid, rcfg, generator)
            batch = batch_to(ds.sample_batch(), device)
            loss, n_eff = train_step(model, optimizer, grid, batch, rcfg,
                                     learning_rate(lr, max_steps, step), generator)
            if step % log_every == 0:
                logger.scalar("train/loss", float(loss), step)
                logger.scalar("train/n_eff_samples", float(n_eff), step)
                logger.scalar("perf/rays_per_sec",
                              batch_size * (step + 1) / (time.time() - tic), step)
    finally:
        logger.close()
    return {"params": model.state_dict(), "grid": grid, "model": model, "rcfg": rcfg,
            "dataset": ds, "elapsed_s": time.time() - tic}


def render_view(model, grid, rcfg, view, chunk=8192):
    """The eval render of one ``BlenderDataset.full_image`` view, in chunks
    of ``chunk`` rays without jitter: (h*w, 3) rgb on the model's device."""
    device = next(model.parameters()).device
    bkgd = torch.from_numpy(view["color_bkgd"]).to(device)
    n = view["rays_o"].shape[0]
    with torch.no_grad():
        return torch.cat([render_blender_rays(
            model, torch.from_numpy(view["rays_o"][j:j + chunk]).to(device),
            torch.from_numpy(view["rays_d"][j:j + chunk]).to(device), bkgd, rcfg,
            occ_grid=grid, train=False)["rgb"] for j in range(0, n, chunk)])


def eval_psnr(result, split="test", root_fp="data/nerf_synthetic", subject_id="lego",
              n_images=None, chunk=8192):
    """The mean over the first ``n_images`` views of ``split`` (all by
    default) of each view's PSNR, for a :func:`train_vanilla` result."""
    ds = BlenderDataset(subject_id, root_fp, split=split)
    model, grid, rcfg = result["model"], result["grid"], result["rcfg"]
    psnrs = []
    for i in range(n_images or len(ds)):
        view = ds.full_image(i)
        rgb = render_view(model, grid, rcfg, view, chunk)
        psnrs.append(float(M.psnr(rgb, torch.from_numpy(view["pixels"]).to(rgb.device))))
    return float(np.mean(psnrs))
