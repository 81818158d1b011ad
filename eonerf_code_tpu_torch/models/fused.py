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

The int8 trunk tier (``TrainConfig.trunk_quant`` "int8" or "int8_full")
runs the camera, shadow and coarse ops with their trunk in int8; the
per-point field and density ops stay in the compute dtype, as in the JAX
package. ``TrainConfig.bwd_acts="saved"`` (the default) makes the camera
and shadow ops keep the trunk's activations from the forward for the
backward, all or nothing per step (``KernelField.step_save_ok``). A
step of the coarse-to-fine PE annealing renders through a copy carrying
its mask (``with_pe_mask``; models/freq_reg.py): every kernel reads the
masked trunk through the one pack, no kernel changes.
"""

import copy

import torch

from eonerf_code_tpu_torch.models.freq_reg import field_weights
from eonerf_code_tpu_torch.ops.fused_field import (
    fused_density,
    fused_field,
    pack_kernel_weights,
)
from eonerf_code_tpu_torch.ops.fused_render import (
    fits_saved_cap,
    fused_camera,
    fused_coarse,
    fused_shadow,
    saved_stream_bytes,
)


def _device_of(field):
    return next(field.parameters()).device


TRUNK_QUANT = {"int8": True, "int8_full": "full"}


def make_render_field(field, cfg=None):
    """The field the renderer should evaluate through (the JAX package's
    models/fused.py::make_render_field), by ``cfg.use_pallas`` (a
    TrainConfig, or anything with its ``use_pallas``, ``trunk_quant`` and
    ``bwd_acts``; None reads as all defaults):

    - None: ``KernelField`` for a bfloat16 field with the 8x256 trunk on a
      CUDA device (the fused kernels' shape and type), the field itself
      otherwise (the per-sample path, where ``bwd_acts`` means nothing);
    - False: the field itself, also on the card;
    - True: ``KernelField``. Its ops run their plain versions on CPU tensors
      (in float32 or bfloat16); a trunk other than 8x256, or on the card a
      dtype other than bfloat16, raises ``ValueError`` naming it. Nothing
      falls back.

    ``trunk_quant`` selects the int8 trunk tier and ``bwd_acts`` the
    saved-activations backward; the two are not combined (the JAX package
    falls back to the recompute backward, with a notice)."""
    use_pallas = getattr(cfg, "use_pallas", None)
    on_card = _device_of(field).type == "cuda"
    shape_ok = field.net_depth == 8 and field.net_width == 256
    if use_pallas is None:
        use_pallas = field.compute_dtype == torch.bfloat16 and on_card and shape_ok
    elif use_pallas:
        if not shape_ok:
            raise ValueError(f"use_pallas=True: the fused kernels take the 8x256 trunk, not "
                             f"{field.net_depth}x{field.net_width}")
        if on_card and field.compute_dtype != torch.bfloat16:
            raise ValueError(f"use_pallas=True: the fused kernels take bfloat16 on the card, "
                             f"not {field.compute_dtype}")
    if not use_pallas:
        return field
    quant = TRUNK_QUANT.get(getattr(cfg, "trunk_quant", "none"), False)
    save_acts = getattr(cfg, "bwd_acts", "recompute") == "saved"
    if quant and save_acts:
        print("trunk_quant=int8: bwd_acts=saved unsupported, falling back to recompute",
              flush=True)
        save_acts = False
    return KernelField(field, trunk_quant=quant, save_acts=save_acts)


class KernelField:
    """Fused-render adapter over an ``EONerfField``. On CPU tensors the ops
    run their plain versions, which is how the tests drive it.
    ``trunk_quant`` (False, True for int8, "full" for int8_full) goes to the
    camera, shadow and coarse ops; ``tile`` and ``bwd_tile`` are their
    scale-group targets in rows, forward and backward (the JAX package's
    ``PallasField`` tile sizes). ``save_acts``: the camera and shadow ops
    keep the trunk's activations for the backward when the step's streams
    fit ``save_acts_cap_mb`` (:meth:`step_save_ok`) and the call's own does
    (the per-call gate); never with ``trunk_quant``. ``pe_mask``: the
    coarse-to-fine PE mask of a step (None: unmasked), set on a copy by
    :meth:`with_pe_mask`."""

    supports_fused_render = True
    pe_mask = None

    def __init__(self, field, trunk_quant=False, tile=2048, bwd_tile=1024, save_acts=False,
                 save_acts_cap_mb=8192):
        if save_acts and trunk_quant:
            raise ValueError("save_acts is never combined with the int8 trunk tier")
        self.field = field
        self.trunk_quant = trunk_quant
        self.tile = tile
        self.bwd_tile = bwd_tile
        self.save_acts = save_acts
        self.save_acts_cap_mb = save_acts_cap_mb
        self.beta_min = field.beta_min
        self.rpc_correction = field.rpc_correction
        self.n_images = field.n_images
        self.compute_dtype = field.compute_dtype

    def with_pe_mask(self, pe_mask):
        """A copy of this field whose packs carry ``pe_mask``."""
        view = copy.copy(self)
        view.pe_mask = pe_mask
        return view

    def pack(self):
        """Kernel-ready float32 weights from the field's current parameters,
        differentiable; the ops cast them to the compute dtype (and the int8
        tier quantizes them). The step's PE mask is applied in the logical
        layout, before the packing pads and reorders the PE rows
        (``field_weights``, the JAX package's ``PallasField`` on masked
        params). One pack serves the camera and the shadow pass of a step,
        and the per-sample branch's field and density ops."""
        return pack_kernel_weights(field_weights(self), torch.float32)

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

    def step_save_ok(self, r, k_cam, k_sc=0):
        """The all-or-nothing saved-activations gate of one render step (the
        JAX package's ``PallasField.step_save_ok``): True only when the sum
        of the step's streams (camera K = k_cam, shadow K = k_sc; 0 = no
        shadow pass), both live from forward to backward, fits
        ``save_acts_cap_mb``. The sum fitting implies each stream fits the
        per-call gate (the same cap and predicate), so a True here means both
        ops save: a step never mixes a saving op with a recomputing one."""
        if not self.save_acts:
            return False
        total = saved_stream_bytes(r, k_cam, self.compute_dtype)
        if k_sc:
            total += saved_stream_bytes(r, k_sc, self.compute_dtype)
        return total <= self.save_acts_cap_mb * 2**20

    def _save(self, save_ok, z):
        """The per-call gate: the step's ``save_ok`` and this stream's fit."""
        return (self.save_acts and save_ok
                and fits_saved_cap(z.shape[0], z.shape[1], self.compute_dtype,
                                   self.save_acts_cap_mb))

    def fused_camera(self, weights, rayin, z, deltam, save_ok=True):
        return fused_camera(weights, rayin, z, deltam, self.compute_dtype, self.trunk_quant,
                            self.tile, self.bwd_tile, self._save(save_ok, z))

    def fused_shadow(self, weights, rayin, z, deltam, mask, save_ok=True):
        return fused_shadow(weights, rayin, z, deltam, mask, self.compute_dtype,
                            self.trunk_quant, self.tile, self.bwd_tile, self._save(save_ok, z))

    def fused_coarse(self, weights, rayin, z, deltam):
        """Per-sample weights (R, K) of the density-only coarse pass; no
        gradient (the fine samples are drawn under a stop-gradient)."""
        return fused_coarse(weights, rayin, z, deltam, self.compute_dtype, self.trunk_quant,
                            self.tile)

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
