"""U-FNO processor (counterpart of ``nps_tpu/models/ufno.py``): per block, a
spectral FNO layer and a full mini-U-Net run on the same input, are summed,
then activated. The FNO layer has no activation of its own.

``remat`` and ``remat_policy`` take the JAX package's values (a policy is
None or ``"save_conv_outputs"``; any other raises ``ValueError``). With
``remat`` each block's FNO layer and U-Net are rematerialized apart
(:func:`~nps_tpu_torch.models.common.remat_block`), as the JAX package
wraps ``FNO_Layer`` and ``UNetModern`` in ``nn.remat`` one by one: the
backward recomputes them, keeping only their conv outputs under
``"save_conv_outputs"``. They change what a backward pass keeps, so they do
nothing without a gradient: serving runs the same with or without them."""

import torch
from torch import nn

from nps_tpu_torch.common.interfaces import D, M
from nps_tpu_torch.models.activations import resolve_activation
from nps_tpu_torch.models.common import REMAT_POLICIES, remat_block
from nps_tpu_torch.models.fno import FNO_Layer
from nps_tpu_torch.models.unet_modern import UNetModern


class UFNO(nn.Module):
    model_interface = M.AR_TB
    data_interface = (D.sim1d, D.sim1d_var_t, D.sim2d)

    def __init__(self, pde=None, num_spatial_dims=1, n_cond=0,
                 hidden_features=128, hidden_blocks=4, cond_mode="concat",
                 padding_mode="circular", fno_modes=48, fno_kernel_size=1,
                 fno_conv_mode="single", activation="gelu", norm=False,
                 ch_mults=(1, 1, 1), is_attn=(False, False, False),
                 mid_attn=False, n_blocks=1, use1x1=True, remat=False,
                 remat_policy=None):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"Unknown remat policy {remat_policy!r}")
        self.remat, self.remat_policy = bool(remat), remat_policy
        self.hidden_blocks = int(hidden_blocks)
        assert cond_mode in ("film", "concat", None), \
            "Incorrect conditioning mode supplied"
        if cond_mode == "film":
            # dead upstream path: the reference forwards cond_mode into its
            # UNet branch, whose constructor accepts only concat/None
            raise ValueError(
                "UFNO cond_mode='film' is a dead path upstream (the UNet "
                "branch only supports concat/None); use cond_mode='concat' "
                "or a pure FNO processor for FiLM")
        self.cond_mode = cond_mode
        self.act = resolve_activation(activation)
        hidden_in = (hidden_features + n_cond if cond_mode == "concat"
                     else hidden_features)
        pm = padding_mode if padding_mode != "ones" else "zeros"
        self.fno_layers = nn.ModuleList()
        self.unet_layers = nn.ModuleList()
        for _ in range(hidden_blocks):
            self.fno_layers.append(FNO_Layer(
                hidden_dim=hidden_in, hidden_dim_out=hidden_features,
                num_spatial_dims=num_spatial_dims, modes=fno_modes,
                feature_transform=False, feature_transform_dim=n_cond,
                kernel_size=fno_kernel_size, conv_mode=fno_conv_mode,
                padding_mode=pm, activation=None))
            self.unet_layers.append(UNetModern(
                pde=pde, num_spatial_dims=num_spatial_dims, n_cond=n_cond,
                hidden_features=hidden_features, cond_mode=cond_mode,
                activation=activation, norm=norm, ch_mults=tuple(ch_mults),
                is_attn=tuple(is_attn), mid_attn=mid_attn, n_blocks=n_blocks,
                use1x1=use1x1, padding_mode=padding_mode))

    def block(self, i, h, variables=None, variables_broadcast=None,
              pos=None):
        """Block ``i`` (FNO layer + U-Net, summed, activated) on h."""
        fno_layer, unet = self.fno_layers[i], self.unet_layers[i]
        if self.remat:
            fno_layer = remat_block(fno_layer, self.remat_policy)
            unet = remat_block(unet, self.remat_policy)
        h_in = (torch.cat([h, variables_broadcast], dim=1)
                if variables_broadcast is not None else h)
        h_unet = unet(h, variables_broadcast=variables_broadcast, pos=pos)
        return self.act(fno_layer(h_in) + h_unet)

    def forward(self, h, variables=None, variables_broadcast=None, pos=None):
        for i in range(self.hidden_blocks):
            h = self.block(i, h, variables, variables_broadcast, pos)
        return h
