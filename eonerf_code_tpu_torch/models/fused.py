"""The kernel-backed render field and the one place that picks the backend.

``KernelField`` wraps an ``EONerfField`` for the renderer. On its fused
branch the per-sample work (field + compositing) goes through the fused
camera and shadow ops (ops/fused_render.py), forward and backward, and the
hierarchical sampler's coarse pass through the coarse op. On the
per-sample branch (ray entropy, the nadir diagnostics) the field call goes
through the per-point field op and ``density`` (shadow samples, nadir
probes, the trainer's weight-entropy probe) through the per-point density
op (ops/fused_field.py), both differentiable. The per-ray heads (ambient,
radiometric, ray offset) stay on the module. Gradients reach the field's
parameters through the packing and the ops' weight gradients, and the
transient embedding through the ops' d_rayin or per-point d_emb.
"""

import torch

from eonerf_code_tpu_torch.ops.fused_field import (
    fused_density,
    fused_field,
    pack_kernel_weights,
    pack_params,
)
from eonerf_code_tpu_torch.ops.fused_render import fused_camera, fused_coarse, fused_shadow


def _device_of(field):
    return next(field.parameters()).device


def make_render_field(field):
    """The field the renderer should evaluate through: ``KernelField`` for a
    bfloat16 field with the 8x256 trunk on a CUDA device (the fused
    kernels' shape and type), the field itself otherwise (the per-sample
    path)."""
    use_kernels = (field.compute_dtype == torch.bfloat16
                   and _device_of(field).type == "cuda"
                   and field.net_depth == 8 and field.net_width == 256)
    return KernelField(field) if use_kernels else field


class KernelField:
    """Fused-render adapter over an ``EONerfField``. On CPU tensors the ops
    run their plain versions, which is how the tests drive it."""

    supports_fused_render = True

    def __init__(self, field):
        self.field = field
        self.beta_min = field.beta_min
        self.rpc_correction = field.rpc_correction
        self.n_images = field.n_images
        self.compute_dtype = field.compute_dtype

    def pack(self):
        """Kernel-ready float32 weights from the field's current parameters,
        differentiable; the ops cast them to the compute dtype. One pack
        serves the camera and the shadow pass of a step."""
        return pack_kernel_weights(pack_params(self.field), torch.float32)

    def __call__(self, pos, sun_d, img_idx):
        """``EONerfField.forward`` through the per-point field op: pos
        (R, K, 3), sun_d (R, 3), img_idx (R,) -> sigma (R, K), albedo
        (R, K, 3), ambient (R, 3), transient_s (R, K, 1), transient_beta
        (R, K, 1). The embedding is gathered per ray and expanded to the
        points, so autograd sums the per-point d_emb back into the table."""
        r, k, _ = pos.shape
        emb = self.transient_embedding(img_idx).to(pos.dtype)
        emb = emb[:, None, :].expand(r, k, emb.shape[-1]).reshape(r * k, -1)
        sigma, albedo, t_s, t_beta = fused_field(self.pack(), pos.reshape(-1, 3), emb,
                                                 self.compute_dtype)
        return (sigma.reshape(r, k), albedo.reshape(r, k, 3), self.ambient(sun_d),
                t_s.reshape(r, k, 1), t_beta.reshape(r, k, 1))

    def transient_embedding(self, img_idx):
        return self.field.transient_encoder(img_idx)

    def fused_camera(self, weights, rayin, z, deltam):
        return fused_camera(weights, rayin, z, deltam, self.compute_dtype)

    def fused_shadow(self, weights, rayin, z, deltam, mask):
        return fused_shadow(weights, rayin, z, deltam, mask, self.compute_dtype)

    def fused_coarse(self, weights, rayin, z, deltam):
        """Per-sample weights (R, K) of the density-only coarse pass; no
        gradient (the fine samples are drawn under a stop-gradient)."""
        return fused_coarse(weights, rayin, z, deltam, self.compute_dtype)

    def density(self, pos):
        """sigma at (..., 3) positions through the per-point density op."""
        flat = pos.reshape(-1, 3)
        return fused_density(self.pack(), flat, self.compute_dtype).reshape(pos.shape[:-1])

    def ambient(self, sun_d):
        return self.field.ambient(sun_d)

    def radiometric(self, img_idx):
        return self.field.radiometric(img_idx)

    def ray_offset(self, img_idx):
        return self.field.ray_offset(img_idx)
