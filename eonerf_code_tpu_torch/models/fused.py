"""The kernel-backed render field and the one place that picks the backend.

``KernelField`` wraps an ``EONerfField`` for the renderer's fused branch:
per-sample work (field + compositing) goes through the fused camera and
shadow ops (ops/fused_render.py), forward and backward, the per-ray heads
(ambient, radiometric, ray offset) stay on the module. Gradients reach the
field's parameters through the packing and the ops' weight gradients, and
the transient embedding through the ops' d_rayin.
"""

import torch

from eonerf_code_tpu_torch.ops.fused_field import pack_params
from eonerf_code_tpu_torch.ops.fused_render import fused_camera, fused_shadow, pack_kernel_weights


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

    def ambient(self, sun_d):
        return self.field.ambient(sun_d)

    def radiometric(self, img_idx):
        return self.field.radiometric(img_idx)

    def ray_offset(self, img_idx):
        return self.field.ray_offset(img_idx)
