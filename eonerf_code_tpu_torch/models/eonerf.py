"""The EO-NeRF radiance field as an ``nn.Module``.

Architecture (reference radiance_fields/eonerf.py:69-170, as in the JAX
package's models/eonerf.py):

- trunk: 8x256 skip-MLP over a degree-10 positional encoding of xyz
- sigma head: Linear(256->1) + softplus
- bottleneck: Linear(256->256)
- albedo head: 1x128 MLP -> 3, sigmoid
- transient head: per-image 4-d embedding concat bottleneck -> 4x128 MLP ->
  {transient shadow scalar (sigmoid), uncertainty beta (softplus)}
- ambient head: 1x128 MLP over a degree-4 encoding of the sun direction ->
  3, sigmoid, evaluated once per ray (it depends only on the sun direction)
- optional per-image 9-d radiometric embedding (A:3, b:3, ambient_bias:3)
  initialised to the identity transform
- optional per-image ray-origin translation (bundle adjustment), zero init

Submodule and parameter names follow the flax module's scopes so that the
weight bridge (interop/jax_params.py) is a renaming plus a transpose.
"""

import torch
from torch import nn

from eonerf_code_tpu_torch.models.encoders import sinusoidal_encode, sinusoidal_latent_dim
from eonerf_code_tpu_torch.models.mlp import MLP


def softplus(x):
    """log(1 + e^x) written as logaddexp(x, 0), as flax's ``nn.softplus``."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


class EONerfField(nn.Module):
    def __init__(self, n_images, net_depth=8, net_width=256, skip_layer=4,
                 pos_enc_deg=10, view_enc_deg=4, transient_dim=4,
                 radiometric_normalization=True, rpc_correction=False,
                 beta_min=0.05, compute_dtype=torch.float32, device="cuda",
                 generator=None):
        """Parameters are drawn on the CPU from ``generator`` (a CPU
        ``torch.Generator``; None = the global one), so one seed gives the
        same weights on every device, then moved to ``device``."""
        super().__init__()
        self.n_images = n_images
        self.net_depth = net_depth
        self.net_width = net_width
        self.pos_enc_deg = pos_enc_deg
        self.view_enc_deg = view_enc_deg
        self.radiometric_normalization = radiometric_normalization
        self.rpc_correction = rpc_correction
        self.beta_min = beta_min
        self.compute_dtype = compute_dtype
        cd, half, g = compute_dtype, net_width // 2, generator
        pe_dim = sinusoidal_latent_dim(3, 0, pos_enc_deg)
        sun_dim = sinusoidal_latent_dim(3, 0, view_enc_deg)
        self.trunk = MLP(pe_dim, net_depth=net_depth, net_width=net_width,
                         skip_layer=skip_layer, compute_dtype=cd, generator=g)
        # a skip concat after the last trunk layer widens its output
        trunk_out = net_width + (pe_dim if self.trunk._skips_after(net_depth - 1) else 0)
        self.sigma_head = MLP(trunk_out, output_dim=1, net_depth=0,
                              output_activation=softplus, compute_dtype=cd, generator=g)
        self.bottleneck = MLP(trunk_out, output_dim=net_width, net_depth=0,
                              compute_dtype=cd, generator=g)
        self.albedo_mlp = MLP(net_width, output_dim=3, net_depth=1, net_width=half,
                              skip_layer=None, output_activation=torch.sigmoid,
                              compute_dtype=cd, generator=g)
        self.transient_mlp = MLP(net_width + transient_dim, net_depth=4,
                                 net_width=half, skip_layer=None,
                                 compute_dtype=cd, generator=g)
        self.transient_scalar = MLP(half, output_dim=1, net_depth=0,
                                    output_activation=torch.sigmoid,
                                    compute_dtype=cd, generator=g)
        self.transient_beta = MLP(half, output_dim=1, net_depth=0,
                                  output_activation=softplus, compute_dtype=cd,
                                  generator=g)
        self.ambient_mlp = MLP(sun_dim, output_dim=3, net_depth=1, net_width=half,
                               skip_layer=None, output_activation=torch.sigmoid,
                               compute_dtype=cd, generator=g)
        self.transient_encoder = nn.Embedding(n_images, transient_dim)
        nn.init.normal_(self.transient_encoder.weight, 0.0, 1.0, generator=g)
        if radiometric_normalization:
            self.radiometric_enc = nn.Embedding(n_images, 9)
            with torch.no_grad():
                self.radiometric_enc.weight.zero_()
                self.radiometric_enc.weight[:, 0:3] = 1.0
        if rpc_correction:
            self.ray_correction_enc = nn.Embedding(n_images, 3)
            nn.init.zeros_(self.ray_correction_enc.weight)
        self.to(device)

    def ray_offset(self, img_idx):
        """Per-image translation of the ray origins in the normalized frame;
        zero when rpc_correction is off."""
        if self.rpc_correction:
            return self.ray_correction_enc(img_idx)
        return torch.zeros((*img_idx.shape, 3), dtype=self.compute_dtype,
                           device=img_idx.device)

    def density(self, x):
        """sigma(x) for (..., 3) positions."""
        h = self.trunk(sinusoidal_encode(x, 0, self.pos_enc_deg))
        return self.sigma_head(h)[..., 0]

    def forward(self, x, sun_d, img_idx):
        """x (R, K, 3) sample positions, sun_d (R, 3), img_idx (R,) ->
        sigma (R, K), albedo (R, K, 3), ambient (R, 3) [per ray],
        transient_s (R, K, 1), transient_beta (R, K, 1)."""
        h = self.trunk(sinusoidal_encode(x, 0, self.pos_enc_deg))
        sigma = self.sigma_head(h)[..., 0]
        feats = self.bottleneck(h)
        albedo = self.albedo_mlp(feats)
        ambient = self.ambient(sun_d)
        emb = self.transient_encoder(img_idx).to(feats.dtype)
        emb = emb[:, None, :].expand(*feats.shape[:-1], emb.shape[-1])
        th = self.transient_mlp(torch.cat([feats, emb], dim=-1))
        return sigma, albedo, ambient, self.transient_scalar(th), self.transient_beta(th)

    def ambient(self, sun_d):
        """Per-ray ambient colour head."""
        return self.ambient_mlp(sinusoidal_encode(sun_d, 0, self.view_enc_deg))

    def radiometric(self, img_idx):
        """Per-image radiometric transform (A, b, ambient_bias); identity
        when radiometric normalization is off."""
        if self.radiometric_normalization:
            e = self.radiometric_enc(img_idx)
            return e[..., 0:3], e[..., 3:6], e[..., 6:9].abs()
        ones = torch.ones((*img_idx.shape, 3), dtype=self.compute_dtype,
                          device=img_idx.device)
        return ones, torch.zeros_like(ones), torch.zeros_like(ones)
