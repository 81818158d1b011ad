"""Kernel-ready views of the EO-NeRF field's per-sample parameters.

The counterpart of the helpers in the JAX package's
ops/pallas/fused_field.py. Matrices keep the JAX package's (in, out)
layout, biases are (1, d) rows, so :class:`FieldWeights` compares one to one
with the JAX ``FieldWeights``. Every step here is differentiable: gradients
reach the field's parameters through the packing, and the rows that
``pad_pe_rows`` adds drop out of them again (``unpad_pe_rows`` is the same
cut, for gradients held in padded form). The kernels of that file
(per-point field and density) are not part of this slice.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

POS_DEG = 10               # positional encoding degrees
PE_DIM = 3 + 6 * POS_DEG   # 63
PE_PAD = 64                # the kernels' PE width: 63 lanes + one zero lane
N_WEIGHTS = 36
N_DENSITY_WEIGHTS = 18     # trunk (8 + 8) + sigma head (2)


class FieldWeights(NamedTuple):
    """Flat view of the EONerfField per-sample parameters."""

    trunk_w: tuple  # 8 matrices; layer 5 takes the skip concat (319, 256)
    trunk_b: tuple  # 8 x (1, 256)
    sigma_w: torch.Tensor  # (256, 1)
    sigma_b: torch.Tensor  # (1, 1)
    bott_w: torch.Tensor   # (256, 256)
    bott_b: torch.Tensor   # (1, 256)
    alb_w0: torch.Tensor   # (256, 128)
    alb_b0: torch.Tensor   # (1, 128)
    alb_w1: torch.Tensor   # (128, 3)
    alb_b1: torch.Tensor   # (1, 3)
    tr_w: tuple  # 4 matrices; the first is (260, 128)
    tr_b: tuple  # 4 x (1, 128)
    ts_w: torch.Tensor     # (128, 1)
    ts_b: torch.Tensor     # (1, 1)
    tb_w: torch.Tensor     # (128, 1)
    tb_b: torch.Tensor     # (1, 1)


def pack_params(field):
    """EONerfField -> FieldWeights (float32 views of the parameters, on the
    field's device; differentiable)."""

    def wb(mlp, name):
        layer = getattr(mlp, name)
        return layer.weight.t(), layer.bias.reshape(1, -1)

    trunk_w, trunk_b = zip(*(wb(field.trunk, f"hidden_{i}") for i in range(8)))
    sigma_w, sigma_b = wb(field.sigma_head, "output")
    bott_w, bott_b = wb(field.bottleneck, "output")
    alb_w0, alb_b0 = wb(field.albedo_mlp, "hidden_0")
    alb_w1, alb_b1 = wb(field.albedo_mlp, "output")
    tr_w, tr_b = zip(*(wb(field.transient_mlp, f"hidden_{i}") for i in range(4)))
    ts_w, ts_b = wb(field.transient_scalar, "output")
    tb_w, tb_b = wb(field.transient_beta, "output")
    return FieldWeights(tuple(trunk_w), tuple(trunk_b), sigma_w, sigma_b,
                        bott_w, bott_b, alb_w0, alb_b0, alb_w1, alb_b1,
                        tuple(tr_w), tuple(tr_b), ts_w, ts_b, tb_w, tb_b)


def flatten_weights(w: FieldWeights):
    return [*w.trunk_w, *w.trunk_b, w.sigma_w, w.sigma_b, w.bott_w, w.bott_b,
            w.alb_w0, w.alb_b0, w.alb_w1, w.alb_b1, *w.tr_w, *w.tr_b,
            w.ts_w, w.ts_b, w.tb_w, w.tb_b]


def unflatten_weights(flat):
    it = list(flat)
    return FieldWeights(tuple(it[0:8]), tuple(it[8:16]), it[16], it[17],
                        it[18], it[19], it[20], it[21], it[22], it[23],
                        tuple(it[24:28]), tuple(it[28:32]), it[32], it[33],
                        it[34], it[35])


def density_subset(w: FieldWeights):
    return [*w.trunk_w, *w.trunk_b, w.sigma_w, w.sigma_b]


def is_bias(x):
    return x.dim() == 2 and x.shape[0] == 1


def cast_matrices(flat, dtype):
    """Weight MATRICES to the compute dtype; biases stay float32 (they are
    added to float32 accumulators)."""
    return [x if is_bias(x) else x.to(dtype) for x in flat]


def pad_pe_rows(flat, with_transient=False):
    """Zero-pad trunk W0 (63 -> 64 rows), W5 (319 -> 320 rows) and, for the
    full field, transient W0 (260 -> 320 rows, matching the 64-wide padded
    embedding block) so every kernel operand has an aligned width."""
    out = list(flat)
    out[0] = F.pad(out[0], (0, 0, 0, 1))
    out[5] = F.pad(out[5], (0, 0, 0, 1))
    if with_transient:
        out[24] = F.pad(out[24], (0, 0, 0, 60))
    return out


def unpad_pe_rows(flat, with_transient=False):
    """Inverse of :func:`pad_pe_rows` (for weight gradients in padded form)."""
    out = list(flat)
    out[0] = out[0][:PE_DIM]
    out[5] = out[5][:256 + PE_DIM]
    if with_transient:
        out[24] = out[24][:260]
    return out
