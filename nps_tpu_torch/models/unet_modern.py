"""Modern U-Net processor (counterpart of ``nps_tpu/models/unet_modern.py``).

Resolutions from ``ch_mults`` with ``n_blocks`` wide ResidualBlocks each,
a strided-conv Downsample that downsamples the conditioning grid in
lockstep, a MiddleBlock, UpBlocks that take skip connections re-aligned by
``crop_nd``, transposed-conv Upsample, conditioning concatenated at every
block input, and a final GroupNorm(8)+act+conv+crop. NCHW throughout.

In every ResidualBlock with one norm group, GroupNorm and the activation
after it run as one fused op (the GN+GELU kernel for CUDA tensors) when the
activation is a GELU, the exact one or the tanh-approximate one of
``cfg_ns512_ufno``; with another one the kernel normalises and the
activation follows.

``is_attn`` (per level) and ``mid_attn`` add an :class:`AttentionBlock`
after the level's (or the middle's first) ResidualBlock: single-head
spatial self-attention over every cell of the field, with the reference's
softmax over the query axis (under a row split: every rank's keys and
values fetched, the softmax's shift and sum taken over the x group).

Every block passes on ``rows``, the global length of its input's first
spatial axis: under spatial parallelism (a row-split field) the convs, the
crops and the norms need it (:mod:`nps_tpu_torch.models.common`); unsplit
it is the input's own length.
"""

import torch
from torch import nn

from nps_tpu_torch.common.interfaces import D, M
from nps_tpu_torch.models.activations import fused_gelu, resolve_activation
from nps_tpu_torch.models.common import (ConvND, ConvTransposeND, Dense,
                                         GroupNorm, crop_nd)
from nps_tpu_torch.parallel import spatial
from nps_tpu_torch.parallel.spatial import rows_of


def _padding_kwargs(padding_mode):
    assert padding_mode in ("ones", "circular")
    if padding_mode == "ones":
        return dict(padding=1, padding_mode="zeros")
    # the reference passes padding_mode='circular' with padding=0: valid
    return dict(padding="valid", padding_mode="zeros")


class ResidualBlock(nn.Module):
    """Pre-activation wide residual block."""

    def __init__(self, in_channels, out_channels, activation="gelu",
                 norm=False, n_groups=1, num_spatial_dims=1,
                 padding_mode="ones"):
        super().__init__()
        nd = num_spatial_dims
        pk = _padding_kwargs(padding_mode)
        self.nd = nd
        self.act = resolve_activation(activation)
        # the GELU form GroupNorm(1) fuses ("none", "tanh"), or None
        self.fused_gelu = fused_gelu(activation)
        self.conv1 = ConvND(in_channels, out_channels, 3, nd, **pk)
        self.conv2 = ConvND(out_channels, out_channels, 3, nd, **pk)
        if norm:
            self.norm1 = GroupNorm(n_groups, in_channels)
            self.norm2 = GroupNorm(n_groups, out_channels)
        else:
            self.norm1 = self.norm2 = None
        if in_channels != out_channels:
            self.shortcut = ConvND(in_channels, out_channels, 1, nd,
                                   padding="valid")
        else:
            self.shortcut = None

    def _norm_act(self, norm, x, rows):
        if norm is None:
            return self.act(x)
        if norm.num_groups == 1:
            if self.fused_gelu is None:
                return self.act(norm.with_gelu(x, gelu=False, rows=rows))
            return norm.with_gelu(x, approximate=self.fused_gelu, rows=rows)
        return self.act(norm(x, rows))

    def forward(self, x, rows=None):
        rows = rows_of(x, rows)
        h = self.conv1(self._norm_act(self.norm1, x, rows), rows)
        mid = self.conv1.out_rows(rows)
        h = self.conv2(self._norm_act(self.norm2, h, mid), mid)
        shortcut = x if self.shortcut is None else self.shortcut(x)
        return crop_nd(h, shortcut.shape, self.nd, self.conv2.out_rows(mid),
                       rows) + shortcut


class AttentionBlock(nn.Module):
    """Single-head spatial self-attention, [b, c, *sp] -> [b, c, *sp], as
    the U-Net's blocks build it (one head, d_k = c): the cells as a
    sequence, a ``projection`` to q, k, v, the scores q k^T c^-0.5 in f32,
    their softmax over the QUERY axis (the reference's ``softmax(dim=1)``
    of its ``bijh`` scores, kept), the weighted sum of v, an ``output``
    projection and an identity shortcut. ``norm`` is the reference's
    GroupNorm, never applied: its parameters are kept so that checkpoints
    carry across both ways."""

    def __init__(self, in_channels):
        super().__init__()
        self.d_k = in_channels
        self.norm = GroupNorm(1, in_channels)
        self.projection = Dense(in_channels, 3 * self.d_k)
        self.output = Dense(self.d_k, in_channels)

    def forward(self, x, rows=None):
        b, c, *sp = x.shape
        h = x.reshape(b, c, -1).transpose(1, 2)               # [b, seq, c]
        q, k, v = self.projection(h).float().split(self.d_k, dim=-1)
        axis = spatial.current()
        if axis is not None and len(sp) == 2:
            res = self._split_attention(q, k, v, axis, rows_of(x, rows),
                                        sp[1])
        else:
            scores = torch.matmul(q, k.transpose(1, 2)) * self.d_k ** -0.5
            res = torch.matmul(torch.softmax(scores, dim=1), v)
        res = self.output(res) + h                            # [b, seq, c]
        # NCHW again, contiguous as the GN+GELU kernel takes it
        return res.transpose(1, 2).reshape(b, c, *sp).contiguous()

    def _split_attention(self, q, k, v, axis, rows, width):
        """The attention of this rank's queries (its rows' cells) under a
        row split of ``rows`` global rows of ``width`` cells: every rank's
        keys and values fetched (``spatial.fetch_all_rows``; the backward
        adds each row's gradient into its owner), and the softmax over the
        queries of every rank: its shift the maximum over the x group
        (``spatial.max_``), its sum a ``spatial_sum`` of the local sums of
        ``exp``. Returns [b, local seq, d_k]."""
        b, n, d = k.shape
        kv = torch.cat([k, v], dim=-1).reshape(b, 1, n // width, -1)
        kv = spatial.fetch_all_rows(kv, rows, axis).reshape(b, -1, 2 * d)
        k, v = kv.split(d, dim=-1)
        scores = torch.matmul(q, k.transpose(1, 2)) * self.d_k ** -0.5
        shift = spatial.max_(scores.detach().amax(dim=1, keepdim=True)
                             .contiguous(), axis)
        e = torch.exp(scores - shift)
        total = spatial.spatial_sum(e.sum(dim=1, keepdim=True), axis)
        return torch.matmul(e / total, v)


class DownBlock(nn.Module):
    def __init__(self, in_channels, out_channels, has_attn=False,
                 activation="gelu", norm=False, num_spatial_dims=1,
                 padding_mode="ones"):
        super().__init__()
        self.res = ResidualBlock(in_channels, out_channels, activation, norm,
                                 num_spatial_dims=num_spatial_dims,
                                 padding_mode=padding_mode)
        self.attn = AttentionBlock(out_channels) if has_attn else None

    def forward(self, x, variables_broadcast=None, rows=None):
        if variables_broadcast is not None:
            x = torch.cat([x, variables_broadcast], dim=1)
        x = self.res(x, rows)
        if self.attn is not None:
            x = self.attn(x, rows)
        return x, variables_broadcast


class UpBlock(nn.Module):
    def __init__(self, in_channels, out_channels, has_attn=False,
                 activation="gelu", norm=False, num_spatial_dims=1,
                 padding_mode="ones"):
        super().__init__()
        # input channels include the concatenated skip (in + out)
        self.res = ResidualBlock(in_channels + out_channels, out_channels,
                                 activation, norm,
                                 num_spatial_dims=num_spatial_dims,
                                 padding_mode=padding_mode)
        self.attn = AttentionBlock(out_channels) if has_attn else None

    def forward(self, x, rows=None):
        x = self.res(x, rows)
        return x if self.attn is None else self.attn(x, rows)


class MiddleBlock(nn.Module):
    def __init__(self, in_channels, out_channels, has_attn=False,
                 activation="gelu", norm=False, num_spatial_dims=1,
                 padding_mode="ones"):
        super().__init__()
        kw = dict(num_spatial_dims=num_spatial_dims, padding_mode=padding_mode)
        self.res1 = ResidualBlock(in_channels, out_channels, activation, norm,
                                  **kw)
        self.attn = AttentionBlock(out_channels) if has_attn else None
        self.res2 = ResidualBlock(out_channels, out_channels, activation,
                                  norm, **kw)

    def forward(self, x, variables_broadcast=None, rows=None):
        if variables_broadcast is not None:
            x = torch.cat([x, variables_broadcast], dim=1)
        x = self.res1(x, rows)
        if self.attn is not None:
            x = self.attn(x, rows)
        return self.res2(x, rows), variables_broadcast


class Downsample(nn.Module):
    """k=3, s=2 conv; also downsamples the conditioning grid in lockstep."""

    def __init__(self, n_channels, num_spatial_dims, n_cond,
                 padding_mode="ones"):
        super().__init__()
        pk = _padding_kwargs(padding_mode)
        nd = num_spatial_dims
        self.conv = ConvND(n_channels, n_channels, 3, nd, strides=2, **pk)
        self.conv_variables_broadcast = (
            ConvND(n_cond, n_cond, 3, nd, strides=2, **pk) if n_cond > 0
            else None)

    def forward(self, x, variables_broadcast=None, rows=None):
        y = self.conv(x, rows)
        if variables_broadcast is not None:
            return y, self.conv_variables_broadcast(variables_broadcast, rows)
        return y, None


class Upsample(nn.Module):
    """2x upsample via transposed conv k=4, s=2; circular mode wrap-pads by
    (k-1)//2 = 1 first (``ConvTranspose2d_padded``)."""

    def __init__(self, n_channels, num_spatial_dims, padding_mode="ones"):
        super().__init__()
        self.conv = ConvTransposeND(
            n_channels, n_channels, 4, num_spatial_dims, strides=2,
            pre_pad=1 if padding_mode == "circular" else 0)

    def forward(self, x, rows=None):
        return self.conv(x, rows)


class UNetModern(nn.Module):
    """Modern U-Net; h [b, hidden, *sp] in and out."""

    model_interface = M.AR_TB
    data_interface = (D.sim1d, D.sim2d, D.sim1d_var_t)

    def __init__(self, pde=None, num_spatial_dims=1, n_cond=0,
                 hidden_features=128, cond_mode="concat", activation="gelu",
                 norm=False, ch_mults=(1, 2, 2, 4),
                 is_attn=(False, False, False, False), mid_attn=False,
                 n_blocks=2, use1x1=False, padding_mode="ones"):
        super().__init__()
        assert cond_mode in ("concat", None)
        nd = num_spatial_dims
        self.nd = nd
        self.cond_mode = cond_mode
        self.ch_mults = tuple(ch_mults)
        self.n_blocks = n_blocks
        self.act = resolve_activation(activation)
        n_cond = n_cond if cond_mode == "concat" else 0
        blk = dict(activation=activation, norm=norm, num_spatial_dims=nd,
                   padding_mode=padding_mode)
        n_res = len(self.ch_mults)

        self.down = nn.ModuleList()
        out_ch = in_ch = hidden_features
        for i in range(n_res):
            out_ch = in_ch * self.ch_mults[i]
            for _ in range(n_blocks):
                self.down.append(DownBlock(in_ch + n_cond, out_ch,
                                           has_attn=is_attn[i], **blk))
                in_ch = out_ch
            if i < n_res - 1:
                self.down.append(Downsample(in_ch, nd, n_cond,
                                            padding_mode=padding_mode))

        self.middle = MiddleBlock(out_ch + n_cond, out_ch, has_attn=mid_attn,
                                  **blk)

        self.up = nn.ModuleList()
        in_ch = out_ch
        for i in reversed(range(n_res)):
            out_ch = in_ch
            for _ in range(n_blocks):
                self.up.append(UpBlock(in_ch + n_cond, out_ch,
                                       has_attn=is_attn[i], **blk))
            out_ch = in_ch // self.ch_mults[i]
            self.up.append(UpBlock(in_ch + n_cond, out_ch,
                                   has_attn=is_attn[i], **blk))
            in_ch = out_ch
            if i > 0:
                self.up.append(Upsample(in_ch, nd, padding_mode=padding_mode))

        # group_norm(h, 8) in the JAX package: not what the GN kernel
        # computes, so it stays the plain GroupNorm followed by the activation
        self.norm = GroupNorm(8, hidden_features) if norm else None
        if use1x1:
            self.final = ConvND(hidden_features, hidden_features, 1, nd,
                                padding="valid")
        else:
            self.final = ConvND(hidden_features, hidden_features, 3, nd,
                                **_padding_kwargs(padding_mode))

    def forward(self, h, variables_broadcast=None, pos=None):
        nd = self.nd
        if self.cond_mode is None:
            variables_broadcast = None
        assert h.ndim == 2 + nd, "expects [b, c, *spatial]"
        h_shape = h.shape
        # the global length of the first spatial axis at each point
        rows = h_rows = rows_of(h)
        h_feats = [(h, rows)]
        vb_feats = [variables_broadcast]

        for block in self.down:
            h, variables_broadcast = block(h, variables_broadcast, rows)
            if isinstance(block, Downsample):
                rows = block.conv.out_rows(rows)
            h_feats.append((h, rows))
            vb_feats.append(variables_broadcast)

        h, variables_broadcast = self.middle(h, variables_broadcast, rows)

        for block in self.up:
            if isinstance(block, Upsample):
                h = block(h, rows)
                rows = block.conv.out_rows(rows)
                continue
            skip, skip_rows = h_feats.pop()
            parts = [h, crop_nd(skip, h.shape, nd, skip_rows, rows)]
            vb = vb_feats.pop()
            if vb is not None:
                parts.append(crop_nd(vb, h.shape, nd, skip_rows, rows))
            h = block(torch.cat(parts, dim=1), rows)

        if self.norm is not None:
            h = self.norm(h, rows)
        h = self.final(self.act(h), rows)
        return crop_nd(h, h_shape, nd, self.final.out_rows(rows), h_rows)
