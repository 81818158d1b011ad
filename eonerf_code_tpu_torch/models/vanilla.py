"""The vanilla NeRF radiance field of the Blender (nerf_synthetic) path, as
the JAX package's models/vanilla.py (reference radiance_fields/mlp.py:
114-250): an 8x256 skip trunk over a degree-10 encoding of xyz, a sigma
head (ReLU), and a bottleneck joined with a degree-4 encoding of the view
direction through a 1x128 rgb MLP (sigmoid).

Submodule names are the flax scopes (``trunk``, ``sigma_head``,
``bottleneck``, ``rgb_mlp``), so the weight bridge
(interop/jax_params.py) is a renaming plus a transpose.
"""

import torch
from torch import nn

from eonerf_code_tpu_torch.models.encoders import sinusoidal_encode, sinusoidal_latent_dim
from eonerf_code_tpu_torch.models.mlp import MLP


class VanillaNeRF(nn.Module):
    def __init__(self, net_depth=8, net_width=256, skip_layer=4, net_depth_condition=1,
                 net_width_condition=128, pos_enc_deg=10, view_enc_deg=4,
                 compute_dtype=torch.float32, device="cuda", generator=None):
        """Parameters are drawn on the CPU from ``generator`` (a CPU
        ``torch.Generator``; None = the global one), so one seed gives the
        same weights on every device, then moved to ``device``."""
        super().__init__()
        self.pos_enc_deg = pos_enc_deg
        self.view_enc_deg = view_enc_deg
        cd, g = compute_dtype, generator
        pe_dim = sinusoidal_latent_dim(3, 0, pos_enc_deg)
        self.trunk = MLP(pe_dim, net_depth=net_depth, net_width=net_width,
                         skip_layer=skip_layer, compute_dtype=cd, generator=g)
        # a skip concat after the last trunk layer widens its output
        trunk_out = net_width + (pe_dim if self.trunk._skips_after(net_depth - 1) else 0)
        self.sigma_head = MLP(trunk_out, output_dim=1, net_depth=0, compute_dtype=cd,
                              generator=g)
        self.bottleneck = MLP(trunk_out, output_dim=net_width, net_depth=0, compute_dtype=cd,
                              generator=g)
        self.rgb_mlp = MLP(net_width + sinusoidal_latent_dim(3, 0, view_enc_deg),
                           output_dim=3, net_depth=net_depth_condition,
                           net_width=net_width_condition, skip_layer=None,
                           compute_dtype=cd, generator=g)
        self.to(device)

    def density(self, x):
        """(..., 3) positions -> (...) sigma >= 0."""
        pe = sinusoidal_encode(x, 0, self.pos_enc_deg)
        return torch.relu(self.sigma_head(self.trunk(pe))[..., 0])

    def forward(self, x, viewdirs):
        """x (..., 3) positions; viewdirs broadcastable to them, e.g.
        (R, 1, 3) for (R, K, 3). Returns (rgb in [0, 1], sigma >= 0)."""
        h = self.trunk(sinusoidal_encode(x, 0, self.pos_enc_deg))
        sigma = torch.relu(self.sigma_head(h)[..., 0])
        cond = sinusoidal_encode(viewdirs, 0, self.view_enc_deg)
        cond = cond.to(h.dtype).expand(*h.shape[:-1], cond.shape[-1])
        rgb = torch.sigmoid(self.rgb_mlp(torch.cat([self.bottleneck(h), cond], dim=-1)))
        return rgb, sigma
