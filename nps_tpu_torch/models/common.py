"""Shared model building blocks, NCHW (counterpart of
``nps_tpu/models/common.py``).

Padding geometry follows the reference exactly:
- ``padding='same'`` with ``padding_mode='circular'`` wrap-pads and then runs
  a valid conv (DRN and FNO_Layer pointwise convs);
- the U-Net's "circular" mode builds its convs with ``padding=0``, i.e.
  valid convs whose shapes ``crop_nd`` re-aligns by zero padding;
- transposed convs may wrap-pad by ``pre_pad`` cells first
  (``ConvTranspose2d_padded``).

Parameters keep the PyTorch reference's names and layouts (conv
``weight [O, I, *k]``, transposed conv ``[I, O, *k]``, linear ``[O, I]``,
GroupNorm ``weight``/``bias``), so ``nps_tpu.compat.convert_state_dict``
maps a port ``state_dict`` onto the ``nps_tpu`` tree. :class:`BCEncoder`
keeps the reference's ``nn.Sequential`` named ``bc_encoder`` (conv_in at
index 0, conv_h*k* at 2k + 2, the ``Linear`` at the highest index).

Under a bf16 compute dtype (:mod:`nps_tpu_torch.models.config`) the convs,
transposed convs and dense layers cast their input and their f32 weights
to it and produce their output in it (cuDNN and cuBLAS accumulate in f32);
the bias is added in the output's type. With no compute dtype set they run
in the input's type, as the JAX package does. The GroupNorms keep f32
statistics and return the input's type.

:func:`remat_block` is the counterpart of the JAX package's ``nn.remat``
with ``resolve_remat_policy``: a processor wraps each block in it so that a
backward pass recomputes the block instead of keeping its activations.

Under spatial parallelism (:mod:`nps_tpu_torch.parallel.spatial`: a model
apply inside ``spatial.scope``) a 2D or 3D field holds only this rank's
rows of its first spatial axis, and the ops whose result crosses rows take
the split into account: :class:`ConvND` and :class:`ConvTransposeND` fetch
the rows their outputs need from the neighbours (wrapping around where the
padding is circular, zeros only at the global edges), :func:`crop_nd`
crops and pads at the global edges, and the GroupNorms sum their
statistics over the x group. Each takes ``rows``, the global row count of
its input (the grid's, where the caller passes none); ``out_rows`` gives
its output's.

Under tensor parallelism (a model apply inside ``parallel.scope`` of a
model axis) a layer whose weight the partition rule splits (``tp_sharded``,
set by ``parallel.tensor.setup``) holds its share of the output channels:
:class:`ConvND`, :class:`ConvTransposeND` and :class:`Dense` compute that
share (and their slice of the bias) from the whole input and gather it
over the model group (``parallel.tensor.sharded_layer``).
"""

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from nps_tpu_torch.models import initializers as init
from nps_tpu_torch.models.activations import resolve_activation
from nps_tpu_torch.models.config import (compute_dtype, compute_dtype_scope,
                                         fast_forward_active)
from nps_tpu_torch.ops.group_norm import (gn_gelu, gn_gelu_split,  # noqa: F401
                                          group_norm_plain, group_norm_split)
from nps_tpu_torch.parallel import spatial, tensor

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _tuple(v, n):
    if isinstance(v, (tuple, list)):
        assert len(v) == n
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _cast(x, weight, bias):
    """``x``, ``weight`` and ``bias`` in the compute dtype, else in x's.
    Where nothing changes type (f32 throughout) it returns them untouched:
    three no-op ``.to`` calls per conv cost the host-bound U-Net train step
    3-5% on an H100 (PERF.md)."""
    dt = compute_dtype() or x.dtype
    if x.dtype == dt and weight.dtype == dt:
        return x, weight, bias
    return (x.to(dt), weight.to(dt),
            None if bias is None else bias.to(dt))


# the JAX package's remat policies (nps_tpu/models/common.py:
# resolve_remat_policy): None recomputes the whole block,
# "save_conv_outputs" keeps the conv outputs and recomputes the rest
REMAT_POLICIES = (None, "save_conv_outputs")


def _save_conv_outputs(ctx, op, *args, **kwargs):
    """The "save_conv_outputs" policy: keep what ``aten.convolution``
    returns (the outputs of :class:`ConvND` and :class:`ConvTransposeND`,
    which the JAX package tags ``conv_out``) and recompute every other op.
    Allocations are recomputed too, so a hand kernel that writes through
    ``data_ptr()`` into a fresh ``torch.empty`` gets a fresh buffer again."""
    if op is torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_block(fn, policy=None):
    """``fn`` wrapped so that, where a gradient is wanted, the backward
    pass recomputes it from its inputs instead of keeping its activations
    (``torch.utils.checkpoint``, non-reentrant). ``policy`` is one of
    :data:`REMAT_POLICIES`: None keeps nothing, ``"save_conv_outputs"``
    keeps the conv outputs (selective checkpointing). The recompute runs in
    the compute dtype and the grid axis the forward ran in, whatever is
    set when the backward runs (so it makes the forward's collectives again,
    in the same order on every rank). Without gradients ``fn`` runs as it is. The blocks draw no random
    numbers, so the RNG state is not saved."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"Unknown remat policy {policy!r}")
    context_fn = (partial(create_selective_checkpoint_contexts,
                          _save_conv_outputs)
                  if policy == "save_conv_outputs" else noop_context_fn)

    def run(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        dtype, axis = compute_dtype(), spatial.active()

        def block(*a, **kw):
            with compute_dtype_scope(dtype), spatial.scope(axis):
                return fn(*a, **kw)

        return checkpoint(block, *args, use_reentrant=False,
                          context_fn=context_fn, preserve_rng_state=False,
                          **kwargs)

    return run


def _torch_pad(pads):
    """[(lo, hi) per spatial dim, first dim first] -> F.pad's order."""
    out = []
    for lo, hi in reversed(pads):
        out += [lo, hi]
    return out


def circular_pad(x, pad_widths, num_spatial_dims):
    """Wrap-pad the trailing spatial axes of [b, c, *sp] by (lo, hi) each.
    A pad wider than its axis wraps around more than once, as the JAX
    package's ``jnp.pad(mode="wrap")`` does (``F.pad`` refuses it: a
    Dilated ResNet conv at dilation 8, kernel 5 wraps 16 cells per side)."""
    assert x.ndim == num_spatial_dims + 2, "expects [b, c, *spatial]"
    pads = list(pad_widths)[:num_spatial_dims]
    # F.pad is the path of every conv of the four twophase configs on their
    # 96x64 grid (the one the recorded card times ran); the index wrap
    # serves only pads wider than their axis, on grids narrower than that
    if all(max(lo, hi) <= n for (lo, hi), n in zip(pads, x.shape[2:])):
        return F.pad(x, _torch_pad(pads), mode="circular")
    for d, (lo, hi) in enumerate(pads):
        n = x.shape[2 + d]
        idx = torch.arange(-lo, n + hi, device=x.device) % n
        x = x.index_select(2 + d, idx)
    return x


def _crop_offset(cur, des):
    """The leading pad (negative: crop) of a center crop/pad of ``cur``
    cells to ``des``, with the reference's .5 tie-break: for an odd size
    difference the trailing side gets the extra cell when padding, and the
    leading side loses the extra cell when cropping."""
    return int(round((des - cur) / 2.0 - 0.001))


def crop_nd(x, target_shape, num_spatial_dims, rows=None, target_rows=None):
    """Center crop/zero-pad the trailing spatial dims of ``x`` to those of
    ``target_shape`` (see :func:`_crop_offset`). Under spatial parallelism
    the first spatial axis of a 2D or 3D field is split: it goes from
    ``rows`` to ``target_rows`` global rows (the grid's where None), each
    rank fetching the rows of its output (zeros beyond the global edges)."""
    if hasattr(target_shape, "shape"):
        target_shape = target_shape.shape
    nd = num_spatial_dims
    s_des = tuple(target_shape[-nd:])
    axis = spatial.current()
    if axis is not None and nd >= 2:
        cur = axis.rows if rows is None else rows
        des = axis.rows if target_rows is None else target_rows
        if cur != des:
            lo = _crop_offset(cur, des)
            x = spatial.fetch_rows(
                x, cur, [(o0 - lo, o1 - lo) for o0, o1 in
                         (axis.part(des, q) for q in range(axis.size))],
                False, axis)
        s_des = (x.shape[-nd],) + s_des[1:]
    pads = [(0, 0)] * nd
    slices = [slice(None)] * x.ndim
    changed = False
    for d, des in enumerate(s_des):
        ax = x.ndim - nd + d
        cur = x.shape[ax]
        if cur == des:
            continue
        changed = True
        lo = _crop_offset(cur, des)
        hi = des - cur - lo
        if lo >= 0 and hi >= 0:
            pads[d] = (lo, hi)
        elif lo <= 0 and hi <= 0:
            slices[ax] = slice(-lo, cur + hi if hi < 0 else cur)
        else:
            slices[ax] = slice(max(0, -lo), cur + min(0, hi))
            pads[d] = (max(0, lo), max(0, hi))
    if not changed:
        return x
    x = x[tuple(slices)]
    if any(p != (0, 0) for p in pads):
        x = F.pad(x, _torch_pad(pads))
    return x


class ConvND(nn.Module):
    """Dimension-generic conv, [b, I, *sp] -> [b, O, *sp'].

    padding: 'same' | 'valid' | int (symmetric)
    padding_mode: 'zeros' | 'circular' (consulted where padding occurs)
    """

    tp_sharded = False   # the weight holds this rank's output channels

    def __init__(self, in_channels, features, kernel_size, num_spatial_dims,
                 strides=1, padding="same", padding_mode="zeros", dilation=1,
                 use_bias=True):
        super().__init__()
        nd = num_spatial_dims
        if padding_mode not in ("zeros", "circular"):
            raise ValueError(f"Unsupported padding_mode {padding_mode!r}")
        self.nd = nd
        self.k = _tuple(kernel_size, nd)
        self.strides = _tuple(strides, nd)
        self.dilation = _tuple(dilation, nd)
        if padding == "same":
            total = [d * (k - 1) for k, d in zip(self.k, self.dilation)]
            self.pads = [(t // 2, t - t // 2) for t in total]
        elif padding == "valid":
            self.pads = [(0, 0)] * nd
        elif isinstance(padding, int):
            self.pads = [(padding, padding)] * nd
        else:
            raise ValueError(f"Unsupported padding {padding!r}")
        self.padding_mode = padding_mode
        self.weight = nn.Parameter(torch.empty(features, in_channels, *self.k))
        self.bias = (nn.Parameter(torch.empty(features)) if use_bias
                     else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        fan_in = self.weight.shape[1] * math.prod(self.k)
        init.fan_in_uniform_(self.weight, fan_in, generator)
        if self.bias is not None:
            init.fan_in_uniform_(self.bias, fan_in, generator)

    def out_rows(self, rows):
        """The output's length along the first spatial axis for an input of
        ``rows``."""
        (lo, hi), k = self.pads[0], self.k[0]
        span = self.dilation[0] * (k - 1)
        return (rows + lo + hi - span - 1) // self.strides[0] + 1

    def forward(self, x, rows=None):
        pads = self.pads
        axis = spatial.current()
        if axis is not None and self.nd >= 2:
            x = self._split_rows(x, axis, axis.rows if rows is None else rows)
            pads = [(0, 0)] + pads[1:]

        def conv(x, weight, bias=None):
            if any(p != (0, 0) for p in pads):
                x = (circular_pad(x, pads, self.nd)
                     if self.padding_mode == "circular"
                     else F.pad(x, _torch_pad(pads)))
            return _CONV[self.nd](x, weight, bias, stride=self.strides,
                                  dilation=self.dilation)

        x, weight, bias = _cast(x, self.weight, self.bias)
        model_axis = tensor.current() if self.tp_sharded else None
        if model_axis is not None:
            return tensor.sharded_layer(conv, x, weight, bias, model_axis)
        return conv(x, weight, bias)

    def _split_rows(self, x, axis, rows):
        """The rows of the padded input that this rank's output rows read
        (its share of the :meth:`out_rows` output): fetched from the
        neighbours, wrapped around or zero beyond the global edges."""
        (lo, hi), k, s = self.pads[0], self.k[0], self.strides[0]
        if k == 1 and lo == hi == 0 and s == 1:
            return x
        span = self.dilation[0] * (k - 1)
        out = self.out_rows(rows)
        needs = []
        for q in range(axis.size):
            o0, o1 = axis.part(out, q)
            if o1 <= o0:
                raise ValueError(
                    f"a conv's output of {out} rows leaves rank {q} of "
                    f"spatial_parallel={axis.size} no rows")
            needs.append((o0 * s - lo, (o1 - 1) * s - lo + span + 1))
        return spatial.fetch_rows(x, rows, needs,
                                  self.padding_mode == "circular", axis)


class ConvTransposeND(nn.Module):
    """Torch-semantics transposed conv: out = (n-1)*stride + kernel, after an
    optional circular pre-pad of ``pre_pad`` cells per side."""

    tp_sharded = False

    def __init__(self, in_channels, features, kernel_size, num_spatial_dims,
                 strides=1, pre_pad=0, use_bias=True):
        super().__init__()
        self.nd = num_spatial_dims
        self.k = _tuple(kernel_size, self.nd)
        self.strides = _tuple(strides, self.nd)
        self.pre_pad = int(pre_pad)
        self.weight = nn.Parameter(torch.empty(in_channels, features, *self.k))
        self.bias = (nn.Parameter(torch.empty(features)) if use_bias
                     else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        # torch ConvTranspose: fan_in = out_channels * prod(kernel)
        fan_in = self.weight.shape[1] * math.prod(self.k)
        init.fan_in_uniform_(self.weight, fan_in, generator)
        if self.bias is not None:
            init.fan_in_uniform_(self.bias, fan_in, generator)

    def out_rows(self, rows):
        """The output's length along the first spatial axis for an input of
        ``rows``."""
        return (rows + 2 * self.pre_pad - 1) * self.strides[0] + self.k[0]

    def forward(self, x, rows=None):
        axis = spatial.current()
        if axis is not None and self.nd >= 2:
            return self._split_forward(x, axis,
                                       axis.rows if rows is None else rows)
        if self.pre_pad > 0:
            x = circular_pad(x, [(self.pre_pad, self.pre_pad)] * self.nd,
                             self.nd)
        x, weight, bias = _cast(x, self.weight, self.bias)
        model_axis = tensor.current() if self.tp_sharded else None
        if model_axis is not None:
            return tensor.sharded_layer(
                lambda x, w, b: _CONV_T[self.nd](x, w, b,
                                                 stride=self.strides),
                x, weight, bias, model_axis)
        return _CONV_T[self.nd](x, weight, bias, stride=self.strides)

    def _split_forward(self, x, axis, rows):
        """This rank's share of the :meth:`out_rows` output rows: the
        (pre-padded) input rows they read, fetched from the neighbours and
        wrapped around, the transposed conv of that slab, then the crop to
        this rank's rows."""
        p, s, k = self.pre_pad, self.strides[0], self.k[0]
        last, out = rows + 2 * p - 1, self.out_rows(rows)
        needs, first = [], []
        for q in range(axis.size):
            o0, o1 = axis.part(out, q)
            j0 = max(0, -((k - 1 - o0) // s))   # ceil((o0 - k + 1) / s)
            j1 = min(last, (o1 - 1) // s)
            needs.append((j0 - p, j1 - p + 1))
            first.append(j0)
        x = spatial.fetch_rows(x, rows, needs, True, axis)
        if p > 0:
            x = circular_pad(x, [(0, 0)] + [(p, p)] * (self.nd - 1),
                             self.nd)
        y = _CONV_T[self.nd](*_cast(x, self.weight, self.bias),
                             stride=self.strides)
        o0, o1 = axis.part(out)
        j0 = first[axis.index]
        return y[:, :, o0 - s * j0:o1 - s * j0]


class Dense(nn.Module):
    """Linear layer, [..., in] -> [..., out], weight [out, in]."""

    tp_sharded = False

    def __init__(self, in_features, features, use_bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = (nn.Parameter(torch.empty(features)) if use_bias
                     else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        fan_in = self.weight.shape[1]
        init.fan_in_uniform_(self.weight, fan_in, generator)
        if self.bias is not None:
            init.fan_in_uniform_(self.bias, fan_in, generator)

    def forward(self, x):
        x, weight, bias = _cast(x, self.weight, self.bias)
        model_axis = tensor.current() if self.tp_sharded else None
        if model_axis is not None:
            return tensor.sharded_layer(F.linear, x, weight, bias,
                                        model_axis, dim=-1)
        return F.linear(x, weight, bias)


class GroupNorm(nn.Module):
    """GroupNorm over [b, C, *sp] with f32 statistics (eps 1e-5), output in
    the input's type. With one group, :meth:`with_gelu` runs the fused
    GroupNorm+GELU op (the kernel for CUDA tensors)."""

    def __init__(self, num_groups, num_channels):
        super().__init__()
        self.num_groups = int(num_groups)
        self.weight = nn.Parameter(torch.empty(num_channels))
        self.bias = nn.Parameter(torch.empty(num_channels))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x, rows=None):
        axis = spatial.current()
        if axis is not None and x.ndim >= 4:
            return group_norm_split(x, self.num_groups, self.weight,
                                    self.bias, axis,
                                    axis.rows if rows is None else rows
                                    ).to(x.dtype)
        return group_norm_plain(x, self.num_groups, self.weight,
                                self.bias).to(x.dtype)

    def with_gelu(self, x, gelu=True, approximate="none", rows=None):
        """GroupNorm(1) [+ GELU, exact ("none") or "tanh"], fused. The
        exact form becomes "tanh" inside a no-grad pushforward step under
        ``trainer.pushforward_fast``, as ``activations.GELU`` does."""
        if self.num_groups != 1:
            raise ValueError("the fused op takes one group")
        if approximate == "none" and fast_forward_active():
            approximate = "tanh"
        axis = spatial.current()
        if axis is not None and x.ndim >= 4:
            return gn_gelu_split(x, self.weight, self.bias, gelu,
                                 approximate=approximate, axis=axis,
                                 rows=axis.rows if rows is None else rows)
        return gn_gelu(x, self.weight, self.bias, gelu,
                       approximate=approximate)


class _Activation(nn.Module):
    """An activation callable as a parameter-free module (a Sequential
    slot)."""

    def __init__(self, activation):
        super().__init__()
        self.fn = resolve_activation(activation)

    def forward(self, x):
        return self.fn(x)


class BCEncoder(nn.Module):
    """Encode a boundary-condition or time-conditioning signal [b, c_bc,
    tw] to [b, bc_encoder_out] (counterpart of the JAX package's
    ``BCEncoder``): conv_in, the activation, ``bc_encoder_n_hidden`` x
    (conv, activation), all 1D over the time axis with "same" zero padding,
    then a channel-major flatten and one ``Linear(tw * hidden -> out)``.
    ``bc_encoder_in`` is the number of channels that arrive (the JAX
    package's conv takes it from the data)."""

    def __init__(self, bc_encoder_in, bc_encoder_out, bc_encoder_hidden,
                 bc_encoder_kernel, time_window, num_spatial_dims=1,
                 activation="gelu", bc_encoder_n_hidden=1, **_ignored):
        super().__init__()
        self.n_in, self.n_out = int(bc_encoder_in), int(bc_encoder_out)
        hidden, k = int(bc_encoder_hidden), int(bc_encoder_kernel)
        layers = [ConvND(self.n_in, hidden, k, 1), _Activation(activation)]
        for _ in range(int(bc_encoder_n_hidden)):
            layers += [ConvND(hidden, hidden, k, 1), _Activation(activation)]
        layers += [nn.Flatten(), Dense(int(time_window) * hidden,
                                       self.n_out)]
        self.bc_encoder = nn.Sequential(*layers)

    def forward(self, x):
        if x.shape[1] != self.n_in:
            raise ValueError(
                f"the BC encoder was built for {self.n_in} input channels "
                f"and got {x.shape[1]}: set bc_encoder_in in its spec to the "
                f"channels of bc and t_cond together")
        return self.bc_encoder(x)
