"""The nerf_synthetic (Blender) loader, the port's own copy of the JAX
package's data/nerf_synthetic.py (reference datasets/nerf_synthetic.py:
53-233): ``transforms_{split}.json`` and RGBA PNGs (read by io/png.py),
pinhole rays in OpenGL's camera axes, random-pixel training batches with
white, black or random background compositing.

numpy only, with the JAX loader's arithmetic and draw order, so its batches
are that loader's to the bit; the trainer moves them to the device.
"""

import json
import os

import numpy as np

from eonerf_code_tpu_torch.io.png import read_png

SUBJECT_IDS = ["chair", "drums", "ficus", "hotdog", "lego", "materials", "mic", "ship"]


def load_renderings(root_fp, subject_id, split):
    """(images (N, h, w, c) uint8, camtoworlds (N, 4, 4) float64, focal)."""
    data_dir = os.path.join(root_fp, subject_id)
    with open(os.path.join(data_dir, f"transforms_{split}.json")) as fp:
        meta = json.load(fp)
    images, camtoworlds = [], []
    for frame in meta["frames"]:
        images.append(read_png(os.path.join(data_dir, frame["file_path"] + ".png")))
        camtoworlds.append(frame["transform_matrix"])
    images = np.stack(images, 0)
    camtoworlds = np.stack(camtoworlds, 0).astype(np.float64)
    w = images.shape[2]
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    return images, camtoworlds, focal


class BlenderDataset:
    """RGBA frames and pinhole rays; OpenGL camera axes (y up, z back).
    ``split="trainval"`` joins the train and val frames."""

    def __init__(self, subject_id, root_fp, split="train", color_bkgd_aug="white",
                 num_rays=None, near=2.0, far=6.0, seed=0):
        self.split = split
        self.num_rays = num_rays
        self.training = (num_rays is not None) and split in ("train", "trainval")
        self.color_bkgd_aug = color_bkgd_aug
        self.near, self.far = near, far
        self.rng = np.random.default_rng(seed)
        if split == "trainval":
            i1, c1, focal = load_renderings(root_fp, subject_id, "train")
            i2, c2, _ = load_renderings(root_fp, subject_id, "val")
            self.images = np.concatenate([i1, i2])
            self.camtoworlds = np.concatenate([c1, c2])
        else:
            self.images, self.camtoworlds, focal = load_renderings(root_fp, subject_id, split)
        self.focal = focal
        self.h, self.w = self.images.shape[1:3]
        self.k = np.array([[focal, 0, self.w / 2.0],
                           [0, focal, self.h / 2.0],
                           [0, 0, 1]], np.float64)

    def __len__(self):
        return len(self.images)

    def rays_for_pixels(self, c2w, x, y):
        """Pixel centres -> (origins, viewdirs), float32, computed in
        float64. c2w: per-ray (N, 4, 4) camera-to-world matrices."""
        camera_dirs = np.stack([
            (x + 0.5 - self.k[0, 2]) / self.k[0, 0],
            (y + 0.5 - self.k[1, 2]) / self.k[1, 1] * (-1.0),
            -np.ones_like(x, np.float64),
        ], -1)
        directions = (camera_dirs[:, None, :] * c2w[..., :3, :3]).sum(-1)
        origins = np.broadcast_to(c2w[..., :3, -1], directions.shape)
        viewdirs = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
        return origins.astype(np.float32), viewdirs.astype(np.float32)

    def sample_batch(self, num_rays=None):
        """A random-pixel training batch, dict(rays_o, rays_d, pixels,
        color_bkgd) of numpy arrays. Draws: image id, x, y, then the
        background for ``color_bkgd_aug="random"``."""
        n = num_rays or self.num_rays
        image_id = self.rng.integers(0, len(self.images), n)
        x = self.rng.integers(0, self.w, n)
        y = self.rng.integers(0, self.h, n)
        rgba = self.images[image_id, y, x] / 255.0
        origins, viewdirs = self.rays_for_pixels(self.camtoworlds[image_id], x, y)
        if self.color_bkgd_aug == "white":
            bkgd = np.ones(3, np.float32)
        elif self.color_bkgd_aug == "black":
            bkgd = np.zeros(3, np.float32)
        else:
            bkgd = self.rng.random(3).astype(np.float32)
        pixels = (rgba[:, :3] * rgba[:, 3:] + bkgd * (1 - rgba[:, 3:])).astype(np.float32)
        return {"rays_o": origins, "rays_d": viewdirs, "pixels": pixels, "color_bkgd": bkgd}

    def full_image(self, index):
        """Every ray of one view, composited on white: dict with (h*w, ...)
        arrays, ``h`` and ``w``."""
        x, y = np.meshgrid(np.arange(self.w), np.arange(self.h))
        x, y = x.ravel().astype(np.float64), y.ravel().astype(np.float64)
        c2w = np.broadcast_to(self.camtoworlds[index], (x.shape[0], 4, 4))
        origins, viewdirs = self.rays_for_pixels(c2w, x, y)
        rgba = self.images[index].reshape(-1, 4) / 255.0
        bkgd = np.ones(3, np.float32)
        pixels = (rgba[:, :3] * rgba[:, 3:] + bkgd * (1 - rgba[:, 3:])).astype(np.float32)
        return {"rays_o": origins, "rays_d": viewdirs, "pixels": pixels,
                "color_bkgd": bkgd, "h": self.h, "w": self.w}
