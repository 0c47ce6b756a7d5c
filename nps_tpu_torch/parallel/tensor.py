"""Tensor (model-axis) parallelism: the output channels of the weights
split over the ranks of a model group (counterpart of
``nps_tpu/parallel/tensor.py``).

The JAX package places each parameter with a ``PartitionSpec`` and lets
GSPMD partition the jitted step. The port holds each rank's share of the
weights as the parameter itself and runs each sharded layer's forward by
hand. The partition rule is ``_leaf_spec``'s, on the port's layouts
(:func:`partition_specs`):

- conv weight ``[out, in, *k]`` (:class:`~nps_tpu_torch.models.common.
  ConvND`) and dense weight ``[out, in]`` (``Dense``): axis 0;
- transposed-conv weight ``[in, out, *k]`` (``ConvTransposeND``): axis 1;
- spectral ``weights1..4`` ``[2, ci, co, *modes]`` (``SpectralConvND``;
  1D has ``weights1``, 2D two blocks, 3D four): axis 2;
- a weight whose axis does not divide by K stays whole, as in JAX;
  everything else (biases, the norms' affine) is replicated.

Under ``parallel.scope`` of a model axis a sharded layer computes its
share of the output channels from the whole input and then gathers them,
so every activation between layers is whole and the same on every model
rank:

- the input enters through :func:`copy_in` (identity forward; its backward
  sums the input gradient over the model group, since each rank's share of
  the outputs gives only its part of it);
- the output leaves through :func:`gather` (a one-writer slot all-reduce
  forward, the ``parallel.spatial`` buffer summed on its int32 bit view;
  its backward is the rank's own slice, with no collective, since the
  gradient after the gather is whole on every rank);
- the bias is replicated; each rank's layer call takes its slice (through
  :func:`copy_in`, so its gradient is whole on every rank), which keeps the
  bits of the whole layer's output channels.

So every parameter's gradient is whole on each model rank (a shard's is
its own shard's): the optimizer sums them over the data group only. The
spectral conv runs K1 with the rank's ``co / K`` share of the weights and
of the FiLM factors; the GroupNorm+GELU kernel K2 runs unchanged on the
whole activations. Both collectives are ``all_reduce``, which gloo carries
for CUDA tensors (two ranks sharing one card), at K times the bytes of an
all-gather (ROADMAP: an NCCL all-gather).
"""

import torch
import torch.distributed as dist

from nps_tpu_torch.parallel import spatial
from nps_tpu_torch.parallel.spatial import _exact_sum, _slot_buffer, traffic


def current():
    """The model axis (a ``SpatialAxis`` named "model": group, K, index)
    of the model apply in progress (``parallel.scope``), or None."""
    return spatial.current("model")


def _shard_dims(module):
    """{parameter attribute: the axis its out-features lie on} of a layer
    the rule splits."""
    from nps_tpu_torch.models.common import ConvND, ConvTransposeND, Dense
    from nps_tpu_torch.models.fno import SpectralConvND

    if isinstance(module, (ConvND, Dense)):
        return {"weight": 0}
    if isinstance(module, ConvTransposeND):
        return {"weight": 1}
    if isinstance(module, SpectralConvND):
        return {f"weights{i + 1}": 2 for i in range(len(module._weights()))}
    return {}


def partition_specs(model, k):
    """{parameter name: the axis it splits on over ``k`` model ranks, or
    None (replicated)}."""
    specs = {}
    for prefix, module in model.named_modules():
        dims = _shard_dims(module)
        for name, p in module.named_parameters(recurse=False):
            d = dims.get(name)
            key = f"{prefix}.{name}" if prefix else name
            specs[key] = d if d is not None and p.shape[d] % k == 0 else None
    return specs


def shard_state(state, axis, specs):
    """This model rank's share of a whole ``state_dict``: each split
    tensor's slice along its axis (copies), the others as they are."""
    out = {}
    for key, t in state.items():
        d = specs.get(key)
        if d is None:
            out[key] = t
        else:
            n = t.shape[d] // axis.size
            out[key] = t.narrow(d, axis.index * n, n).clone()
    return out


def merge(shares, spec):
    """The whole tensor from every model rank's share of it (``shares``,
    in rank order; ``spec`` its split axis, or None): the shares
    concatenated, bit for bit. A replicated tensor, or a scalar that goes
    with a split one (an optimizer's step count), is the first rank's."""
    if spec is None or shares[0].dim() == 0:
        return shares[0]
    return torch.cat(shares, dim=spec)


def setup(model, axis, config=None):
    """Mark the layers of ``model`` whose weights the rule splits over the
    model axis ``axis`` to run their sharded forwards under
    ``parallel.scope``; returns the specs (the trainer then loads this
    rank's share, :func:`shard_state`)."""
    specs = partition_specs(model, axis.size)
    for prefix, module in model.named_modules():
        dims = _shard_dims(module)
        keys = [f"{prefix}.{n}" if prefix else n for n in dims]
        if dims and all(specs.get(key) is not None for key in keys):
            module.tp_sharded = True
    return specs


def partial_params(model):
    """The parameters whose gradient is partial on a model rank: none (a
    sharded layer's input and bias enter through :func:`copy_in`)."""
    return []


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        traffic["copy_in_bwd"] += 1
        traffic["copy_in_bwd_bytes"] += g.numel() * g.element_size()
        return g, None


def copy_in(x, axis):
    """``x`` (whole on every rank of ``axis``) entering a computation of
    this rank's share: the identity, whose backward sums the gradient over
    the axis group."""
    return _CopyIn.apply(x, axis)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, dim, axis):
        ctx.dim, ctx.axis, ctx.n = dim, axis, y.shape[dim]
        flat, buf = _slot_buffer((axis.size, *y.shape), y)
        buf[axis.index] = y
        _exact_sum(flat, axis.group)
        traffic["gather"] += 1
        traffic["gather_bytes"] += flat.numel() * flat.element_size()
        return torch.cat(buf.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.axis.index * ctx.n
        return g.narrow(ctx.dim, lo, ctx.n).contiguous(), None, None


def gather(y, dim, axis):
    """Every model rank's ``y`` (an equal share of the channels on
    ``dim``) concatenated in rank order on every rank; its backward is
    this rank's slice of the gradient."""
    return _Gather.apply(y, dim % y.ndim, axis)


def sharded_layer(fn, x, weight, bias, axis, dim=1):
    """A layer's sharded forward: ``fn(x, weight, bias)`` on this rank's
    weight share and its slice of the whole bias (both inputs through
    :func:`copy_in`, so the bias's gradient is whole on every model rank),
    gathered on ``dim``. The bias goes into the layer's own call, which
    then computes each output channel as the whole layer does, bit for
    bit; added after the gather it would round differently."""
    if bias is not None:
        n = bias.shape[0] // axis.size
        bias = copy_in(bias, axis).narrow(0, axis.index * n, n)
    return gather(fn(copy_in(x, axis), weight, bias), dim, axis)


def check(model, k, config=None):
    """Tensor parallelism takes every model, as JAX's rule does: whatever
    layer it holds (the MP-GNN's dense layers on node tensors ``[N, c]``,
    the attention block's projections, the BC encoder's 1D convs and dense
    layer, the 3D convs and spectral weights), a weight whose out-features
    K divides is split and the rest stays whole."""
