"""Spectral conv layer and FNO layer (counterpart of ``nps_tpu/models/fno.py``).

``SpectralConvND`` holds the split-complex weights ``weights1``/``weights2``
(real ``[2, ci, co, m1, m2]``; in 1D ``weights1`` alone, ``[2, ci, co,
m1]``, as the JAX package's one mode block; in 3D ``weights1..4``, ``[2,
ci, co, m1, m2, m3]``, its four corner blocks) and calls
``ops.spectral.spectral_conv_nd``. The port has one route per dimension,
so the layers take no ``mix_impl``: a model spec's value is checked where
the spec is read (``enc_proc_dec.resolve_component``). ``FNO_Layer`` adds
the pointwise-conv bypass, and the ``FNO`` processor
stacks ``hidden_blocks`` of them, conditioned by channel concat of the
broadcast grid (``cond_mode='concat'``) or by FiLM on the spectrum
(``cond_mode='film'``).

The 2D spectral conv runs in the compute dtype (:mod:`.config`; f32 when
none is set) with its weights and their pack in f32; the 1D and the 3D
one in f32, whatever the compute dtype, as the JAX package's. Each 2D
call packs the weights into the CUDA kernel's layout, inside the
autograd Function where a
gradient is wanted. A caller that applies the model many times with fixed
weights (a serving rollout) wraps the calls in
:func:`packed_spectral_weights`, which packs once for the whole block.

Under tensor parallelism (``parallel.scope`` of a model axis) a
``SpectralConvND`` whose weights the rule splits (``tp_sharded``) holds
``co / K`` of their output channels: it runs the spectral conv (K1 on the
card) on the whole input with that share of the weights and of the FiLM
factors, then gathers the output channels over the model group.

Under spatial parallelism (``spatial.scope`` of an x axis: x holds this
rank's rows) a 2D ``SpectralConvND`` runs K1's split entries
(``ops.spectral.spectral_conv_2d_split``) and a 3D one the split
``torch.fft`` route (``spectral_conv_3d_split``).

Each processor applies its blocks through ``block(i, h, ...)``, which
pipeline parallelism calls one stage at a time
(``parallel.pipeline``).
"""

import math
from contextlib import contextmanager

import torch
from torch import nn

from nps_tpu_torch.common.interfaces import D, M
from nps_tpu_torch.models import initializers as init
from nps_tpu_torch.models.activations import resolve_activation
from nps_tpu_torch.models.common import ConvND, Dense, remat_block
from nps_tpu_torch.models.config import compute_dtype
from nps_tpu_torch.ops.spectral import (pack_weights_2d,
                                       spectral_conv_2d_split,
                                       spectral_conv_3d_split,
                                       spectral_conv_nd)
from nps_tpu_torch.parallel import spatial, tensor


@contextmanager
def packed_spectral_weights(model):
    """Pack the weights of every ``SpectralConvND`` in ``model`` once, and
    let the calls inside the block without gradients use that pack. The
    caller keeps the weights fixed inside the block; the packs are dropped
    at its end, so the next block packs whatever the weights are then."""
    layers = [m for m in model.modules()
              if isinstance(m, SpectralConvND) and m.nd == 2]
    try:
        with torch.no_grad():
            for m in layers:
                m.w_packed = pack_weights_2d((m.weights1, m.weights2))
        yield
    finally:
        for m in layers:
            m.w_packed = None


def _modes_tuple(modes, nd):
    if isinstance(modes, int):
        return (modes,) * nd
    modes = tuple(int(m) for m in modes)
    assert len(modes) == nd, \
        "modes must be int or a tuple of length num_spatial_dims"
    return modes


class SpectralConvND(nn.Module):
    """Mode-truncated spectral conv with optional FiLM conditioning;
    [b, ci, *sp] -> [b, co, *sp]."""

    tp_sharded = False   # weights hold this rank's output channels

    def __init__(self, in_channels, out_channels, modes, num_spatial_dims,
                 feature_transform=False, feature_transform_dim=0,
                 transform_mode=1):
        super().__init__()
        nd = num_spatial_dims
        if nd not in (1, 2, 3):
            raise NotImplementedError(f"no {nd}D spectral conv (1D, 2D, 3D)")
        if nd == 3 and feature_transform:
            raise NotImplementedError(
                "FiLM conditioning for 3D spectral convs is not supported "
                "(as in the JAX package)")
        self.nd = nd
        self.modes = _modes_tuple(modes, nd)
        self.transform_mode = transform_mode
        self.scale = 1.0 / (in_channels * out_channels)
        shape = (2, in_channels, out_channels, *self.modes)
        # one mode block in 1D, two in 2D, four in 3D
        for i in range({1: 1, 2: 2, 3: 4}[nd]):
            setattr(self, f"weights{i + 1}", nn.Parameter(torch.empty(shape)))
        self.film_grid = ((out_channels, 2 * self.modes[0], self.modes[1])
                          if nd == 2 else (out_channels, self.modes[0]))
        self.weights_feat = (Dense(feature_transform_dim,
                                   math.prod(self.film_grid))
                             if feature_transform else None)
        self.w_packed = None  # set by packed_spectral_weights
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        for w in self._weights():
            init.uniform_(w, 0.0, 1.0, generator)
            with torch.no_grad():
                w.mul_(self.scale)

    def _weights(self):
        return [getattr(self, f"weights{i + 1}")
                for i in range({1: 1, 2: 2, 3: 4}[self.nd])]

    def forward(self, x, p=None):
        film = None
        if self.weights_feat is not None:
            assert p is not None, "FiLM conditioning requires the cond vector"
            film = self.weights_feat(p).reshape((p.shape[0],) + self.film_grid)
        model_axis = tensor.current() if self.tp_sharded else None
        if model_axis is not None:
            return self._sharded_forward(x, film, model_axis)
        axis = spatial.current()
        if self.nd == 3 and axis is not None:
            # a row-split field: the 3D transform split at its rows
            return spectral_conv_3d_split(x, self._weights(), self.modes,
                                          film=film, axis=axis)
        if self.nd != 2:
            return spectral_conv_nd(x, self._weights(), self.modes, film=film,
                                    film_mode=self.transform_mode,
                                    num_spatial_dims=self.nd)
        # in the compute dtype (f32 when none is set), as the JAX package
        # casts x to f32 and then to the compute dtype; the output has it
        dt = compute_dtype() or torch.float32
        if x.dtype != dt:
            x = x.to(dt)
        if axis is not None:
            # a row-split plane: the transform split at its row contraction
            return spectral_conv_2d_split(
                x, [self.weights1, self.weights2], self.modes, film=film,
                film_mode=self.transform_mode, axis=axis,
                w_packed=self.w_packed)
        # with gradients the CUDA path packs inside SpectralConv2dFn, so the
        # weights stay in the graph; there it ignores w_packed
        return spectral_conv_nd(x, [self.weights1, self.weights2], self.modes,
                                film=film, film_mode=self.transform_mode,
                                num_spatial_dims=self.nd,
                                w_packed=self.w_packed)

    def _sharded_forward(self, x, film, axis):
        """This rank's output channels from the whole input (its share of
        the weights and of the FiLM factors), gathered over the model
        group."""
        if self.nd == 2:
            dt = compute_dtype() or torch.float32
            x = x.to(dt) if x.dtype != dt else x
        x = tensor.copy_in(x, axis)
        if film is not None:
            co = self.weights1.shape[2]
            film = tensor.copy_in(film, axis).narrow(1, axis.index * co, co)
        y = spectral_conv_nd(x, self._weights(), self.modes, film=film,
                             film_mode=self.transform_mode,
                             num_spatial_dims=self.nd)
        return tensor.gather(y, 1, axis)


class FNO_Layer(nn.Module):
    """Spectral conv + pointwise conv(s), summed, optional activation."""

    def __init__(self, hidden_dim, num_spatial_dims=1, kernel_size=1,
                 modes=16, activation="gelu", feature_transform=False,
                 feature_transform_dim=6, transform_mode=0,
                 hidden_dim_out=None, conv_mode="single",
                 padding_mode="circular"):
        super().__init__()
        assert conv_mode in ("single", "double")
        nd = num_spatial_dims
        out_ch = hidden_dim_out or hidden_dim
        self.nd = nd
        self.modes = _modes_tuple(modes, nd)
        self.conv_mode = conv_mode
        self.activation = activation
        self.conv = SpectralConvND(
            hidden_dim, out_ch, self.modes, nd,
            feature_transform=feature_transform,
            feature_transform_dim=feature_transform_dim,
            transform_mode=transform_mode)
        if conv_mode == "single":
            self.w = ConvND(hidden_dim, out_ch, kernel_size, nd,
                            padding="same", padding_mode=padding_mode)
        else:
            self.w = ConvND(hidden_dim, out_ch, 1, nd, padding="same")
            self.w2 = ConvND(hidden_dim, out_ch, kernel_size, nd,
                             padding="same", padding_mode=padding_mode)

    def forward(self, x, p=None):
        # the mode range is checked (ValueError) by spectral_conv_nd
        y = self.conv(x, p) + self.w(x)
        if self.conv_mode == "double":
            y = y + self.w2(x)
        if self.activation is not None:
            y = resolve_activation(self.activation)(y)
        return y


class FNO(nn.Module):
    """FNO processor: ``hidden_blocks`` x :class:`FNO_Layer`, h [b, hidden,
    *sp] in and out. It has no ``activation`` field: its layers always apply
    the default exact GELU. ``padding_mode='ones'`` maps to zero padding.
    With ``remat`` (on by default, as in the JAX package) each layer is
    rematerialized in the backward pass, nothing kept
    (:func:`~nps_tpu_torch.models.common.remat_block`)."""

    model_interface = M.AR_TB
    data_interface = (D.sim1d, D.sim1d_var_t, D.sim2d)

    def __init__(self, pde=None, num_spatial_dims=1, n_cond=0,
                 hidden_features=128, fno_modes=48, hidden_blocks=4,
                 cond_mode="concat", fno_kernel_size=1,
                 fno_conv_mode="single", padding_mode="circular",
                 remat=True):
        super().__init__()
        assert cond_mode in ("film", "concat", None), \
            "Incorrect conditioning mode supplied"
        self.cond_mode = cond_mode
        self.remat = bool(remat)
        self.hidden_blocks = int(hidden_blocks)
        film = cond_mode == "film" and n_cond > 0
        hidden_in = (hidden_features + n_cond if cond_mode == "concat"
                     else hidden_features)
        pm = padding_mode if padding_mode != "ones" else "zeros"
        self.fno_layers = nn.ModuleList(
            FNO_Layer(hidden_dim=hidden_in, hidden_dim_out=hidden_features,
                      num_spatial_dims=num_spatial_dims, modes=fno_modes,
                      feature_transform=film, feature_transform_dim=n_cond,
                      kernel_size=fno_kernel_size, conv_mode=fno_conv_mode,
                      padding_mode=pm)
            for _ in range(hidden_blocks))

    def block(self, i, h, variables=None, variables_broadcast=None,
              pos=None):
        """Layer ``i`` on h."""
        layer = self.fno_layers[i]
        if self.remat:
            layer = remat_block(layer)
        if self.cond_mode == "film":
            return layer(h, p=variables)
        return layer(torch.cat([h, variables_broadcast], dim=1)
                     if variables_broadcast is not None else h)

    def forward(self, h, variables=None, variables_broadcast=None, pos=None):
        for i in range(self.hidden_blocks):
            h = self.block(i, h, variables, variables_broadcast, pos)
        return h
