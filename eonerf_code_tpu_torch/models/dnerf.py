"""D-NeRF, a time-conditioned deformation NeRF, as the JAX package's
models/dnerf.py (reference radiance_fields/mlp.py:253-288, in the
reference's model library but used by none of its entry points, nor
here): a 4x64 warp MLP over the encodings of x and t displaces each point
before a :class:`VanillaNeRF` reads it.
"""

import torch
from torch import nn

from eonerf_code_tpu_torch.models.encoders import sinusoidal_encode, sinusoidal_latent_dim
from eonerf_code_tpu_torch.models.mlp import MLP
from eonerf_code_tpu_torch.models.vanilla import VanillaNeRF


class DNeRF(nn.Module):
    def __init__(self, warp_depth=4, warp_width=64, warp_skip=2, warp_enc_deg=4,
                 compute_dtype=torch.float32, device="cuda", generator=None):
        """Parameters drawn on the CPU from ``generator`` (the warp's, then
        the NeRF's), then moved to ``device``. t has one channel."""
        super().__init__()
        self.warp_enc_deg = warp_enc_deg
        enc_dim = sinusoidal_latent_dim(3, 0, warp_enc_deg) + sinusoidal_latent_dim(
            1, 0, warp_enc_deg)
        self.warp = MLP(enc_dim, output_dim=3, net_depth=warp_depth, net_width=warp_width,
                        skip_layer=warp_skip, compute_dtype=compute_dtype, generator=generator)
        self.nerf = VanillaNeRF(compute_dtype=compute_dtype, device="cpu", generator=generator)
        self.to(device)

    def _warped(self, x, t):
        pe_x = sinusoidal_encode(x, 0, self.warp_enc_deg)
        pe_t = sinusoidal_encode(t, 0, self.warp_enc_deg)
        pe_t = pe_t.expand(*pe_x.shape[:-1], pe_t.shape[-1])
        return x + self.warp(torch.cat([pe_x, pe_t], dim=-1))

    def density(self, x, t):
        return self.nerf.density(self._warped(x, t))

    def forward(self, x, t, viewdirs):
        """x (..., 3), t broadcastable as (..., 1), viewdirs as (..., 3)."""
        return self.nerf(self._warped(x, t), viewdirs)
