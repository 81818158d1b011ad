"""Skip-connection MLP, the building block of the radiance field.

ReLU hidden layers, Xavier-uniform weights, zero biases, and an input skip
that concatenates the ORIGINAL input after the activation of every layer i
with i % skip_layer == 0 and i > 0. ``net_depth=0`` is a single dense layer.

Mixed precision follows flax's ``Dense(dtype=compute_dtype,
param_dtype=float32)``: parameters stay float32; the input, weight and bias
are cast to the compute dtype, the product is rounded to it, and the bias is
added in it.
"""

import torch
from torch import nn


def dense(layer: nn.Linear, x, compute_dtype):
    """flax ``Dense`` arithmetic on an ``nn.Linear`` (weight is (out, in))."""
    y = x.to(compute_dtype) @ layer.weight.to(compute_dtype).t()
    return y + layer.bias.to(compute_dtype)


class MLP(nn.Module):
    def __init__(self, in_dim, output_dim=None, net_depth=8, net_width=256,
                 skip_layer=4, hidden_activation=torch.relu,
                 output_activation=None, compute_dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.net_depth = net_depth
        self.skip_layer = skip_layer
        self.hidden_activation = hidden_activation
        self.output_activation = output_activation
        self.compute_dtype = compute_dtype
        width_in = in_dim
        for i in range(net_depth):
            self.add_module(f"hidden_{i}", nn.Linear(width_in, net_width))
            width_in = net_width
            if self._skips_after(i):
                width_in += in_dim
        self.output_dim = output_dim
        if output_dim is not None:
            self.output = nn.Linear(width_in, output_dim)
        for layer in self.children():
            nn.init.xavier_uniform_(layer.weight, generator=generator)
            nn.init.zeros_(layer.bias)

    def _skips_after(self, i):
        return self.skip_layer is not None and i % self.skip_layer == 0 and i > 0

    def forward(self, x):
        cd = self.compute_dtype
        inputs = x.to(cd)
        x = inputs
        for i in range(self.net_depth):
            x = self.hidden_activation(dense(getattr(self, f"hidden_{i}"), x, cd))
            if self._skips_after(i):
                x = torch.cat([x, inputs], dim=-1)
        if self.output_dim is not None:
            x = dense(self.output, x, cd)
            if self.output_activation is not None:
                x = self.output_activation(x)
        return x
