"""The kernel-backed render field and the one place that picks the backend.

``KernelField`` wraps an ``EONerfField`` for the renderer's fused branch:
per-sample work (field + compositing) goes through the fused camera and
shadow ops (ops/fused_render.py), forward and backward, and the
hierarchical sampler's coarse pass through the coarse op; the per-ray heads
(ambient, radiometric, ray offset) stay on the module. Gradients reach the
field's parameters through the packing and the ops' weight gradients, and
the transient embedding through the ops' d_rayin. ``density`` (the
trainer's weight-entropy probe) goes through the per-point density kernel.
"""

import torch

from eonerf_code_tpu_torch.ops.fused_field import fused_density, pack_kernel_weights, pack_params
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
        """sigma at (..., 3) positions through the density kernel; forward
        only (its backward is not ported and raises)."""
        flat = pos.reshape(-1, 3)
        return fused_density(self.pack(), flat, self.compute_dtype).reshape(pos.shape[:-1])

    def ambient(self, sun_d):
        return self.field.ambient(sun_d)

    def radiometric(self, img_idx):
        return self.field.radiometric(img_idx)

    def ray_offset(self, img_idx):
        return self.field.ray_offset(img_idx)
