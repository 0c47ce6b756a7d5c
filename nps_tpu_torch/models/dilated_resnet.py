"""Dilated ResNet processor (counterpart of
``nps_tpu/models/dilated_resnet.py``; Stachenfeld et al. 2022).

Each block is 7 same-padded convs with dilations (1, 2, 4, 8, 4, 2, 1) and
an activation after each; the broadcast conditioning grid is concatenated
before every block, and a residual wraps each block. With
``padding_mode='circular'`` a conv wrap-pads d*(k-1) cells in all (16 per
side at k=5, d=8) and runs valid. The convs go to cuDNN; no hand kernel.

Parameter names follow the PyTorch reference, so that
``nps_tpu.compat.convert_state_dict`` maps them to
``processor_i/block_b/conv_l``: block b is ``processor.{b}`` and its conv l
is ``layers.{2l}`` (the activations sit at the odd slots of the reference's
Sequential and hold no parameters).

With ``remat`` (on by default, as in the JAX package) each block is
rematerialized in the backward pass
(:func:`~nps_tpu_torch.models.common.remat_block`, nothing kept): it
changes memory, not numbers.
"""

import torch
from torch import nn

from nps_tpu_torch.common.interfaces import D, M
from nps_tpu_torch.models.activations import resolve_activation
from nps_tpu_torch.models.common import ConvND, remat_block


class DilatedResnetBlock(nn.Module):
    def __init__(self, num_spatial_dims=1, hidden_features_in=48,
                 kernel_size=3, dilation_rates=(1, 2, 4, 8, 4, 2, 1),
                 activation="relu", padding_mode="zeros",
                 hidden_features_out=None):
        super().__init__()
        out = hidden_features_out or hidden_features_in
        self.act = resolve_activation(activation)
        layers = []
        c_in = hidden_features_in
        for dil in dilation_rates:
            layers += [ConvND(c_in, out, kernel_size, num_spatial_dims,
                              padding="same", padding_mode=padding_mode,
                              dilation=dil),
                       nn.Identity()]   # the reference's activation slot
            c_in = out
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        for conv in self.layers[::2]:
            x = self.act(conv(x))
        return x


class DilatedResnet(nn.Module):
    """h [b, hidden, *sp] in and out."""

    model_interface = M.AR_TB
    data_interface = (D.sim1d, D.sim2d, D.sim1d_var_t)

    def __init__(self, pde=None, hidden_features=128, kernel_size=3,
                 hidden_blocks=4, activation="relu", padding_mode="zeros",
                 num_spatial_dims=1, n_cond=0, remat=True):
        super().__init__()
        self.remat = bool(remat)
        self.hidden_blocks = int(hidden_blocks)
        self.processor = nn.ModuleList(
            DilatedResnetBlock(
                num_spatial_dims=num_spatial_dims,
                hidden_features_in=hidden_features + n_cond,
                kernel_size=kernel_size, activation=activation,
                padding_mode=padding_mode,
                hidden_features_out=hidden_features)
            for _ in range(hidden_blocks))

    def block(self, i, h, variables=None, variables_broadcast=None,
              pos=None):
        """Residual block ``i`` on h."""
        block = self.processor[i]
        if self.remat:
            block = remat_block(block)
        enc_input = (torch.cat([h, variables_broadcast], dim=1)
                     if variables_broadcast is not None else h)
        return h + block(enc_input)

    def forward(self, h, variables_broadcast=None, pos=None):
        for i in range(self.hidden_blocks):
            h = self.block(i, h, variables_broadcast=variables_broadcast,
                           pos=pos)
        return h
