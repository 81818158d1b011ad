"""Coarse-to-fine frequency regularization (BARF-style) in parameter space
(the JAX package's models/freq_reg.py).

High positional-encoding bands are eased in over training so that the
photometric loss keeps a wide basin while the per-image bundle-adjustment
offsets (``rpc_correction``) converge. The fused kernels build the PE
inside themselves and never hold it, so the mask is folded into the trunk
weights: trunk(pe * m) == trunk_with_masked_rows(pe), since the PE enters
the trunk only through layer 0 and the layer after the skip concat.
Gradients reach the raw parameters; the mask is a constant of the step.

One masked view serves both render paths: :func:`mask_trunk_pe` on the
field's ``FieldWeights`` (ops/fused_field.py::pack_params, the JAX
``(in, out)`` layout). ``KernelField.pack`` packs those for the kernels;
:class:`PEMaskedField` hands their trunk matrices, transposed back to the
module's layout, to the per-sample path through
``torch.func.functional_call``. The module's own parameters stay the raw
ones, so ``state_dict`` keeps its keys.
"""

import torch
from torch import nn
from torch.func import functional_call

from eonerf_code_tpu_torch.models.encoders import barf_alpha, barf_freq_mask
from eonerf_code_tpu_torch.ops.fused_field import pack_params


def step_pe_mask(cfg, step, n_freqs, device="cpu"):
    """The PE mask (3 + 6 n_freqs,) of training step ``step`` under
    ``cfg``'s ramp (``freq_reg_start_step``, ``freq_reg_end_step``), all-ones
    past it, or None when the annealing is off. Computed on the host in
    float32, so the trainer and eval get the same bits, then moved to
    ``device``."""
    if cfg.freq_reg_end_step <= 0:
        return None
    alpha = barf_alpha(step, cfg.freq_reg_start_step, cfg.freq_reg_end_step, n_freqs)
    return barf_freq_mask(alpha, 3, 0, n_freqs).to(device)


def mask_trunk_pe(weights, freq_mask):
    """A copy of ``weights`` (FieldWeights) whose trunk sees a masked PE
    (JAX ``mask_trunk_pe``): layer 0's matrix, whose input dim must equal
    the mask's length, on all rows; a matrix whose input dim is width +
    latent (the layer after a skip concat, input [hidden | PE]) on its last
    latent rows. Every other matrix and every bias passes through."""
    latent = freq_mask.shape[-1]
    w0 = weights.trunk_w[0]
    if w0.shape[0] != latent:
        raise ValueError(f"trunk layer 0 expects input dim {w0.shape[0]}, but the frequency "
                         f"mask has {latent} entries: PE layout mismatch")
    width = w0.shape[1]
    trunk = []
    for i, k in enumerate(weights.trunk_w):
        if i == 0:
            k = k * freq_mask[:, None].to(k.dtype)
        elif k.shape[0] == width + latent:
            m = torch.cat([torch.ones(width, dtype=k.dtype, device=k.device),
                           freq_mask.to(k.dtype)])
            k = k * m[:, None]
        trunk.append(k)
    return weights._replace(trunk_w=tuple(trunk))


def field_weights(render_field):
    """FieldWeights as a render through ``render_field`` sees them: the
    field's, masked when the view carries a ``pe_mask``."""
    field = getattr(render_field, "field", render_field)
    w = pack_params(field)
    mask = getattr(render_field, "pe_mask", None)
    return w if mask is None else mask_trunk_pe(w, mask)


class _Method(nn.Module):
    """One method of a module as ``forward``, so that ``functional_call``
    can swap the module's parameters for it."""

    def __init__(self, module, name):
        super().__init__()
        self.module = module
        self.name = name

    def forward(self, *args):
        return getattr(self.module, self.name)(*args)


class PEMaskedField:
    """The per-sample path's masked view of an ``EONerfField``: ``__call__``
    and ``density`` run the module with its trunk matrices replaced by the
    masked ones (``functional_call``); everything else is the field's."""

    def __init__(self, field, pe_mask):
        self.field = field
        self.pe_mask = pe_mask

    def _run(self, name, *args):
        trunk = {f"module.trunk.hidden_{i}.weight": m.t()
                 for i, m in enumerate(field_weights(self).trunk_w)}
        return functional_call(_Method(self.field, name), trunk, args)

    def __call__(self, pos, sun_d, img_idx):
        return self._run("forward", pos, sun_d, img_idx)

    def density(self, x):
        return self._run("density", x)

    def __getattr__(self, name):
        if name in ("field", "pe_mask"):     # not set yet (a copy in progress)
            raise AttributeError(name)
        return getattr(self.field, name)


def pe_masked(render_field, pe_mask):
    """``render_field`` as a step with ``pe_mask`` sees it: itself when the
    mask is None, a ``KernelField``'s masked copy, or a
    :class:`PEMaskedField` over a plain field."""
    if pe_mask is None:
        return render_field
    if isinstance(render_field, nn.Module):
        return PEMaskedField(render_field, pe_mask)
    return render_field.with_pe_mask(pe_mask)
