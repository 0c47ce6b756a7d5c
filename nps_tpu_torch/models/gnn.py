"""Node-space GNN components for the ``M.AR_TB_GNN`` model interface
(counterpart of ``nps_tpu/models/gnn.py``): an MP-PDE-style message-passing
processor over a static grid graph.

- :class:`NodeElementWise`: per-node two-layer MLP encoder, the node-space
  twin of ``enc_grid.ElementWise``;
- :class:`MPGNN`: message passing; each layer is an edge MLP on
  (h_i, h_j, pos_i - pos_j), aggregated per receiver (mean or sum), then a
  node MLP update with a residual;
- :class:`NodeTimeConvDense`: node-space twin of ``dec_grid.TimeConvDense``,
  emitting a delta via ``add_delta``.

Tensors: nodes ``[N, c, tw]``, features ``[N, hidden]``, positions
``[N, nd]``, ``edge_index`` [2, E] (senders, receivers; receiver-sorted).

The edge MLP's first layer runs in the project-then-gather form, exactly
equal by row-partitioning the weight and linearity of the bias-free position
term: ``W [h_i; h_j; p_i - p_j] + b = (Wr h)[recv] + (Ws h)[send] +
(Wp p)[recv] - (Wp p)[send] + b``. Two paths compute a layer's aggregate:

- shifted grid (``grid_meta`` given: every edge a constant integer offset of
  a regular grid): per offset, the senders are a zero-padded slice of the
  node grid, ``Wp (p_i - p_j)`` a constant vector, and a host mask marks the
  receivers that have a sender at that offset. No gather and no scatter;
  the path ``cfg_twophase_gnn`` takes on the twophase grid;
- gather: ``index_add_`` of the edge messages into their receivers (there is
  no ``torch_geometric``), optionally over ``edge_chunks`` receiver-sorted
  slices whose sums add up; each slice is rematerialized in the backward,
  as in the JAX package, so the edge activations held are one slice's.

The dense layers are plain ``F.linear`` (the JAX package leaves them to XLA;
no Pallas kernel is on this path). Parameters keep the flax module names
(``encoder_0`` -> ``encoder.0``, ``mp_0/edge_0_recv`` ->
``mp.0.edge_0_recv``, ``edge_2`` -> ``edge.2``, ``node_0`` -> ``node.0``),
so ``compat.jax_weights.from_jax_params`` maps the JAX tree. On CUDA,
``index_add_`` sums with atomics in no fixed order: gradients and outputs
are held to tolerances, not bits.

Under a bf16 compute dtype (:mod:`.config`) every dense layer and the
decoder's time convs take and give bf16 (``common.Dense``/``ConvND``), as
the JAX package's ``nn.Dense(dtype=compute_dtype)``: the messages, their
aggregate (``index_add_`` into a bf16 sum, or the shifted path's masked
sum with its masks in bf16), the residual stream and the node update run
in bf16; the in-degrees are counted exactly in f32 and their inverse then
cast to the features' type; the encoder's input concat (the window and
positions f32) is f32 until its first dense layer.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nps_tpu_torch.common.interfaces import D, M
from nps_tpu_torch.models.activations import Swish, resolve_activation
from nps_tpu_torch.models.common import ConvND, Dense, remat_block
from nps_tpu_torch.models.config import compute_dtype
from nps_tpu_torch.models.dec_grid import add_delta


def _shift_slices(sp, off):
    """Slices implementing sender = receiver + off on an sp-shaped grid:
    (src, dst, pads). ``pad(x[src], pads)`` puts each in-bounds sender's
    value at its receiver's position; ``dst`` indexes the receivers that
    have an in-bounds sender for this offset (the mask)."""
    src, dst, pads = [], [], []
    for s, d in zip(sp, off):
        lo, hi = max(d, 0), s + min(d, 0)
        src.append(slice(lo, hi))
        dst.append(slice(lo - d, hi - d))
        pads.append((lo - d, s - (hi - d)))
    return tuple(src), tuple(dst), pads


class NodeElementWise(nn.Module):
    """Per-node two-layer MLP encoder on [window, pos, conditioning]:
    ``num_c * time_window + num_spatial_dims + n_cond`` inputs."""

    def __init__(self, pde=None, num_c=1, num_spatial_dims=1, time_window=25,
                 hidden_features=128, n_cond=0, activation=Swish()):
        super().__init__()
        self.act = resolve_activation(activation)
        in_features = num_c * time_window + num_spatial_dims + n_cond
        self.encoder = nn.ModuleDict({
            "0": Dense(in_features, hidden_features),
            "2": Dense(hidden_features, hidden_features),
        })

    def forward(self, u, pos=None, variables_broadcast=None, **graph):
        parts = [u.reshape(u.shape[0], -1)]   # [N, c*tw], (c, tw) order
        if pos is not None:
            parts.append(pos)
        if variables_broadcast is not None:
            parts.append(variables_broadcast)
        h = self.act(self.encoder["0"](torch.cat(parts, dim=-1)))
        return self.act(self.encoder["2"](h))


class MPGNNLayer(nn.Module):
    """One message-passing step: edge MLP -> aggregate -> node MLP, with a
    residual. ``edge_chunks`` K: the gather path sums the messages of K
    receiver-sorted edge slices (the largest divisor of E not above K)."""

    def __init__(self, hidden_features=128, num_spatial_dims=1,
                 activation=Swish(), aggregate="mean", edge_chunks=1):
        super().__init__()
        c = hidden_features
        self.act = resolve_activation(activation)
        self.aggregate = aggregate
        self.edge_chunks = int(edge_chunks)
        self.edge_0_recv = Dense(c, c)
        self.edge_0_send = Dense(c, c, use_bias=False)
        self.edge_0_pos = Dense(num_spatial_dims, c, use_bias=False)
        self.edge = nn.ModuleDict({"2": Dense(c, c)})
        self.node = nn.ModuleDict({"0": Dense(2 * c, c), "2": Dense(c, c)})

    def _messages(self, hr, hs, pp, send, recv):
        """Sum of the edge messages into their receivers: [N, C]."""
        m = self.act(hr[recv] + hs[send] + pp[recv] - pp[send])
        m = self.act(self.edge["2"](m))
        return torch.zeros_like(hr).index_add_(0, recv, m)

    def _shifted(self, hr, hs, grid):
        """The aggregate on a regular grid: per offset a zero-padded shift
        of the sender projections and a mask of the receivers that have a
        sender there. ``grid`` = (spatial shape, offsets, position deltas
        [K, nd], masks [K, *sp]) on the features' device."""
        sp, offsets, deltas, masks = grid
        c = hr.shape[-1]
        gshape = (hr.shape[0] // math.prod(sp),) + tuple(sp) + (c,)
        hr_g, hs_g = hr.reshape(gshape), hs.reshape(gshape)
        pp_delta = self.edge_0_pos(deltas)   # [K, C] constant per offset
        agg = torch.zeros_like(hr_g)
        for k, off in enumerate(offsets):
            src, _, pads = _shift_slices(sp, off)
            torch_pads = [0, 0]
            for lo, hi in reversed(pads):
                torch_pads += [lo, hi]
            shifted = F.pad(hs_g[(slice(None),) + src], torch_pads)
            m = self.act(hr_g + shifted + pp_delta[k])
            m = self.act(self.edge["2"](m))
            agg = agg + m * masks[k][None, ..., None]
        return agg.reshape(hr.shape[0], c)

    def forward(self, h, pos, edge_index, degree_inv=None, grid=None):
        hr = self.edge_0_recv(h)
        hs = self.edge_0_send(h)
        if grid is not None:
            agg = self._shifted(hr, hs, grid)
        else:
            send, recv = edge_index[0], edge_index[1]
            pp = self.edge_0_pos(pos)
            n_edges = int(send.shape[0])
            k = max(1, min(self.edge_chunks, n_edges))
            while n_edges % k:
                k -= 1
            if k == 1:
                agg = self._messages(hr, hs, pp, send, recv)
            else:
                agg = torch.zeros_like(hr)
                chunk = remat_block(self._messages)
                for s, r in zip(send.reshape(k, -1), recv.reshape(k, -1)):
                    agg = agg + chunk(hr, hs, pp, s, r)
        if self.aggregate == "mean" and degree_inv is not None:
            agg = agg * degree_inv[:, None]
        upd = self.act(self.node["0"](torch.cat([h, agg], dim=-1)))
        return h + self.node["2"](upd)


class MPGNN(nn.Module):
    """Message-passing processor over a static grid graph:
    ``hidden_blocks`` x :class:`MPGNNLayer`, [N, hidden] in and out. With
    node conditioning (``n_cond`` > 0) a ``cond_proj`` dense maps
    [h, conditioning] back to ``hidden_features`` first. The mean
    aggregate divides by each receiver's in-degree, counted exactly in f32.
    ``remat=True`` recomputes each layer in the backward instead of keeping
    its edge activations (:func:`~nps_tpu_torch.models.common.remat_block`,
    nothing kept), as the JAX package does. Under a bf16 compute dtype the
    layers run in bf16 (the module docstring)."""

    model_interface = M.AR_TB_GNN
    data_interface = (D.sim1d, D.sim2d)

    def __init__(self, pde=None, hidden_features=128, hidden_blocks=6,
                 num_spatial_dims=1, n_cond=0, activation=Swish(),
                 aggregate="mean", remat=False, edge_chunks=1):
        super().__init__()
        self.remat = bool(remat)
        if aggregate not in ("mean", "sum"):
            raise ValueError(f"aggregate must be 'mean' or 'sum', got "
                             f"{aggregate!r}")
        self.aggregate = aggregate
        self.cond_proj = (Dense(hidden_features + n_cond, hidden_features)
                          if n_cond else None)
        self.mp = nn.ModuleList(
            MPGNNLayer(hidden_features, num_spatial_dims, activation,
                       aggregate, edge_chunks)
            for _ in range(hidden_blocks))
        self._grid_consts = {}

    def _grid(self, grid_meta, device, dtype):
        """The shifted path's constants on ``device``: (spatial shape,
        offsets, position deltas [K, nd] f32, receiver masks [K, *sp] in
        the messages' ``dtype``). Built once per structure, device and
        type, so a later call (inside a CUDA graph capture, say) copies
        nothing from the host."""
        key = (grid_meta, str(device), dtype)
        if key not in self._grid_consts:
            sp, offsets, deltas = grid_meta
            masks = np.zeros((len(offsets),) + tuple(sp), np.float32)
            for k, off in enumerate(offsets):
                masks[(k,) + _shift_slices(sp, off)[1]] = 1.0
            with torch.inference_mode(False):
                self._grid_consts[key] = (
                    tuple(sp), offsets,
                    torch.tensor(deltas, dtype=torch.float32, device=device),
                    torch.from_numpy(masks).to(device=device, dtype=dtype))
        return self._grid_consts[key]

    def forward(self, h, variables_broadcast=None, pos=None, edge_index=None,
                batch=None, grid_meta=None):
        if edge_index is None:
            raise ValueError("MPGNN needs graph edges")
        degree_inv = None
        if self.aggregate == "mean":
            recv = edge_index[1]
            deg = torch.zeros(h.shape[0], dtype=torch.float32,
                              device=h.device).index_add_(
                0, recv, torch.ones(recv.shape, dtype=torch.float32,
                                    device=h.device))
            degree_inv = torch.where(deg > 0, 1.0 / deg,
                                     torch.zeros_like(deg)).to(h.dtype)
        if variables_broadcast is not None:
            if self.cond_proj is None:
                raise ValueError("MPGNN was built with n_cond=0 but got "
                                 "node conditioning")
            h = self.cond_proj(torch.cat([h, variables_broadcast], dim=-1))
        # the messages' type: the dense layers' output type
        grid = (self._grid(grid_meta, h.device, compute_dtype() or h.dtype)
                if grid_meta is not None else None)
        for layer in self.mp:
            if self.remat:
                layer = remat_block(layer)
            h = layer(h, pos, edge_index, degree_inv, grid)
        return h


class NodeTimeConvDense(nn.Module):
    """Node-space ``TimeConvDense``: dense to tw*3*num_c, then a 2-layer
    time CNN per node, then ``add_delta`` against the last input frame."""

    def __init__(self, pde=None, num_c=1, num_spatial_dims=1, time_window=25,
                 hidden_features=128, activation="gelu",
                 dec_delta_mode="per_step", dec_delta_dt=True):
        super().__init__()
        tw = time_window
        self.pde = pde
        self.tw, self.num_c = tw, num_c
        self.act = resolve_activation(activation)
        self.delta_mode, self.delta_dt = dec_delta_mode, dec_delta_dt
        self.pre_decoder = Dense(hidden_features, tw * 3 * num_c)
        kernel_size_a = math.ceil(tw / 2)
        kernel_size_b = math.ceil(tw / 4) + 1
        if tw % 4 == 0:
            kernel_size_b += 1
        self.decoder = nn.ModuleDict({
            "0": ConvND(num_c, num_c * 2, kernel_size_a, 1, strides=2,
                        padding="valid"),
            "2": ConvND(num_c * 2, num_c, kernel_size_b, 1, padding="valid"),
        })

    def forward(self, h, u, **kwargs):
        x = self.pre_decoder(h).reshape(-1, self.num_c, self.tw * 3)
        x = self.act(self.decoder["0"](x))
        delta = self.decoder["2"](x)                 # [N, num_c, tw]
        # node tensors are [N, c, tw]: the grid layout with 0 spatial dims
        return add_delta(delta, u, self.pde.dt, self.tw, 0,
                         self.delta_mode, self.delta_dt)
