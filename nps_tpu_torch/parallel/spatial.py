"""Spatial parallelism: the first spatial axis of a 2D or 3D field split over
the ranks of an x group (counterpart of ``nps_tpu/parallel/spatial.py``).

In the JAX package GSPMD partitions the jitted step: it inserts the halo
exchanges of the stencil convs and the partial sums of the spectral
contractions and the norm statistics by itself. PyTorch has no such
partitioner, so the port writes each op's sharded form by hand, chiefly out
of two collectives of this module:

- :func:`fetch_rows`: the rows of a split tensor that a rank needs beyond
  its own (a conv's halo, a crop's shifted window, a transposed conv's
  input, every row of the attention's keys and values), as an autograd op
  whose backward adds each fetched row's gradient into its owner's rows;
- :func:`spatial_sum`: a sum over the x group of partial sums (a spectrum
  over the local rows, the norm statistics, the volume totals, the MoE
  gate's pooled mean, the attention softmax's sums over the queries) whose
  backward is a sum over the x group too. The loss's ``global_sum``
  (``parallel.mesh``) passes its gradient through instead: every rank seeds
  the same loss there, while a partial sum's gradient reaches each rank
  only from the ranks that read the total.

A third, :func:`max_`, takes the attention softmax's shift (the maximum
over the queries of every rank) outside autograd.

The MP-GNN and the 1D models have no row axis to split: on an x axis they
run whole on each rank (:func:`whole`). The 3D models split as the 2D ones,
their spectral convs at the row contraction
(``ops.spectral.spectral_conv_3d_split``).

A split tensor of ``rows`` global rows holds on rank s of K the rows
[s * rows // K, (s + 1) * rows // K) (:func:`part`). Each op decides from
the global row counts alone (which every rank knows) which rows each rank
needs, so every rank makes the same collectives in the same order, the
recompute of a rematerialized block included.

All three are ``all_reduce``: gloo carries only ``all_reduce`` and
``broadcast`` for CUDA tensors, and two ranks sharing one card can only
use gloo (NCCL refuses two ranks on one device), so the same code runs
there and on K cards under NCCL. A fetch is an all-reduce of a zeroed
buffer of every rank's halo rows, rank after rank, in which each row has
one writer (its owner); it is summed on its bit view (int32: gloo carries
no int16), so the sum is exact in any float type. It moves K times the
bytes of a send/receive pair (ROADMAP: point-to-point halos under NCCL).

The model code reads the split from :func:`current`, set by the trainer and the
engine with :func:`scope` around a model apply; without one every op runs
unsplit. The one scope carries every regime's axis (tensor, pipeline and expert
parallelism read theirs by name, ``current(name)``). :data:`traffic` counts the
collectives and their bytes.
"""

from collections import Counter, namedtuple
from contextlib import contextmanager
from functools import lru_cache

import torch
import torch.distributed as dist

# calls and bytes of the collectives since the last reset: "fetch",
# "fetch_bytes", "sum", "sum_bytes", "max", "max_bytes" (a backward's
# count under its own name)
traffic = Counter()


def part(n, k, s):
    """Rows [lo, hi) of rank ``s`` of ``k`` in a split of ``n`` rows."""
    return s * n // k, (s + 1) * n // k


class SpatialAxis:
    """This rank's place on an axis of the grid (``name``: the x axis, or
    the model, pipe or expert axis of ``parallel.mesh.Grid``): the axis
    group (a process group, or None for the default one), its size K and
    this rank's index in it. On the x axis ``rows`` is the global row count
    of the grid a model apply runs on (set by :meth:`at`); on the pipe axis
    ``micro`` is the microbatch count (0: one sample each)."""

    def __init__(self, group, size, index, rows=None, name="x", micro=0):
        self.group, self.size, self.index = group, int(size), int(index)
        self.rows, self.name, self.micro = rows, name, int(micro)

    def at(self, rows):
        """This axis for a grid of ``rows`` global rows."""
        return SpatialAxis(self.group, self.size, self.index, int(rows),
                           self.name, self.micro)

    def part(self, n, s=None):
        """Rows [lo, hi) of rank ``s`` (this rank by default) of ``n``."""
        return part(n, self.size, self.index if s is None else s)

    def check(self, n, what="a field"):
        """Raise unless ``n`` rows split evenly over the axis."""
        if n % self.size:
            raise ValueError(f"{what} of {n} rows does not split over "
                             f"spatial_parallel={self.size} ranks")


_CURRENT = [None]


def active():
    """The grid axis (a :class:`SpatialAxis`) of the model apply in
    progress, whatever its name, or None."""
    return _CURRENT[-1]


def current(name="x"):
    """The axis named ``name`` of the model apply in progress, or None."""
    axis = _CURRENT[-1]
    return axis if axis is not None and axis.name == name else None


@contextmanager
def scope(axis):
    """Run the model applies inside on the grid axis ``axis`` (None:
    unsplit): each regime's ops read it by its name."""
    _CURRENT.append(axis)
    try:
        yield
    finally:
        _CURRENT.pop()


def rows_of(x, rows=None):
    """The global length of the first spatial axis of x [b, c, rows, ...]:
    ``rows`` where given, else the grid's under a split, else x's own."""
    if rows is not None:
        return rows
    axis = current()
    return x.shape[2] if axis is None else axis.rows


def _exact_sum(buf, group):
    """All-reduce ``buf`` (whose elements each have at most one nonzero
    writer) on its int32 bit view: exact in any float type."""
    flat = buf.reshape(-1)
    dist.all_reduce(flat.view(torch.int32), group=group)


def _slot_buffer(shape, like):
    """A zeroed ``shape`` buffer of ``like``'s type and device whose byte
    size is a multiple of 4 (for the int32 view)."""
    n = 1
    for d in shape:
        n *= int(d)
    per = max(1, 4 // like.element_size())
    flat = like.new_zeros(-(-n // per) * per)
    return flat, flat[:n].view(shape)


Plan = namedtuple("Plan", "size sends left left_at right right_at keep "
                           "n_local")


@lru_cache(maxsize=None)
def _plan(size, index, rows, needs, wrap):
    """What rank ``index`` of ``size`` sends and keeps when every rank q
    needs the global rows ``needs[q]`` = [lo, hi) of a split of ``rows``;
    rows outside [0, rows) wrap (``wrap``) or are zeros. The buffer holds,
    rank after rank, each rank's left and right halo rows (those before
    and after its own), each row written by its owner alone: ``size``
    rows, ``sends`` (this rank's (buffer rows, its local rows) per halo it
    serves), and where its own halos lie (``left_at``, ``right_at``)."""
    owns = [part(rows, size, q) for q in range(size)]
    a, b = owns[index]
    halos = []
    for (lo, hi), (qa, qb) in zip(needs, owns):
        left = (lo, min(qa, hi)) if lo < qa else (lo, lo)
        right = (max(qb, lo), hi) if hi > qb else (hi, hi)
        halos.append((left, right))
    at, sends = 0, []
    starts = []
    for sides in halos:
        starts.append([])
        for lo, hi in sides:
            ts, srcs = [], []
            for t, i in enumerate(range(lo, hi)):
                g = i % rows if wrap else i
                if 0 <= g < rows and a <= g < b:
                    ts.append(at + t)
                    srcs.append(g - a)
            if ts:
                sends.append((tuple(ts), tuple(srcs)))
            starts[-1].append(at)
            at += hi - lo
    lo, hi = needs[index]
    (l0, l1), (r0, r1) = halos[index]
    k0 = max(lo, a) - a
    keep = (k0, max(k0, min(hi, b) - a))
    return Plan(at, tuple(sends), l1 - l0, starts[index][0], r1 - r0,
                starts[index][1], keep, b - a)


def _index(t, idx):
    return torch.as_tensor(idx, dtype=torch.long, device=t.device)


def _gather(x, axis, plan):
    k0, k1 = plan.keep
    mine = x[:, :, k0:k1]
    if plan.size == 0:
        return mine
    flat, buf = _slot_buffer((*x.shape[:2], plan.size, *x.shape[3:]), x)
    for ts, srcs in plan.sends:
        buf.index_copy_(2, _index(x, ts), x.index_select(2, _index(x, srcs)))
    _exact_sum(flat, axis.group)
    traffic["fetch"] += 1
    traffic["fetch_bytes"] += flat.numel() * flat.element_size()
    return torch.cat([buf[:, :, plan.left_at:plan.left_at + plan.left], mine,
                      buf[:, :, plan.right_at:plan.right_at + plan.right]],
                     dim=2)


def _scatter(g, axis, plan):
    k0, k1 = plan.keep
    gx = g.new_zeros((*g.shape[:2], plan.n_local, *g.shape[3:]))
    gx[:, :, k0:k1] = g[:, :, plan.left:plan.left + k1 - k0]
    if plan.size == 0:
        return gx
    flat, buf = _slot_buffer((*g.shape[:2], plan.size, *g.shape[3:]), g)
    buf[:, :, plan.left_at:plan.left_at + plan.left] = g[:, :, :plan.left]
    buf[:, :, plan.right_at:plan.right_at + plan.right] = g[
        :, :, g.shape[2] - plan.right:]
    _exact_sum(flat, axis.group)
    traffic["fetch_bwd"] += 1
    traffic["fetch_bwd_bytes"] += flat.numel() * flat.element_size()
    for ts, srcs in plan.sends:
        gx.index_add_(2, _index(g, srcs), buf.index_select(2, _index(g, ts)))
    return gx


class _FetchRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, plan):
        ctx.axis, ctx.plan = axis, plan
        return _gather(x, axis, plan)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g.contiguous(), ctx.axis, ctx.plan), None, None


def fetch_rows(x, rows, needs, wrap, axis=None):
    """The slab of global rows ``needs[me]`` = [lo, hi) of the split tensor
    ``x`` [b, c, local rows, ...] of ``rows`` global rows, given every
    rank's ``needs`` (a [lo, hi) per rank of the axis, which every rank
    computes alike). Rows outside [0, rows) wrap around (``wrap``) or are
    zeros. Where no rank needs a row it does not hold, no collective runs."""
    axis = axis or current()
    needs = tuple((int(lo), int(hi)) for lo, hi in needs)
    if len(needs) != axis.size or any(hi < lo for lo, hi in needs):
        raise ValueError(f"fetch_rows needs one [lo, hi) per rank, got "
                         f"{needs}")
    plan = _plan(axis.size, axis.index, int(rows), needs, bool(wrap))
    if x.shape[2] != plan.n_local:
        raise ValueError(f"this rank holds {x.shape[2]} rows of a split of "
                         f"{rows}; its share is {plan.n_local}")
    return _FetchRows.apply(x, axis, plan)


def sum_(t, axis, name="sum"):
    """``t`` (contiguous) summed over the x group in place, outside
    autograd: the collective inside a split kernel op's forward and
    backward. Counted in :data:`traffic` under ``name``."""
    dist.all_reduce(t, group=axis.group)
    traffic[name] += 1
    traffic[name + "_bytes"] += t.numel() * t.element_size()
    return t


class _SpatialSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return sum_(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return sum_(g.contiguous().clone(), ctx.axis, "sum_bwd"), None


def spatial_sum(x, axis=None):
    """``x`` summed over the x group, whose backward sums the gradient over
    the x group too (a partial sum's total is read on every rank)."""
    return _SpatialSum.apply(x, axis or current())


def fetch_all_rows(x, rows, axis=None):
    """Every global row of the split tensor ``x`` [b, c, local rows, ...]
    on every rank (what a cell that reads every other cell needs, as the
    U-Net's attention reads every key): a fetch of all ``rows``, whose
    backward adds each row's gradient into its owner's rows."""
    axis = axis or current()
    return fetch_rows(x, rows, [(0, rows)] * axis.size, False, axis)


def max_(t, axis):
    """``t`` (contiguous) reduced by its maximum over the x group in place,
    outside autograd (a softmax's shift: its gradient is zero). Counted in
    :data:`traffic` under ``max``."""
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=axis.group)
    traffic["max"] += 1
    traffic["max_bytes"] += t.numel() * t.element_size()
    return t


def halo_exchange(x, halo, axis=None):
    """[b, c, halo + n + halo, ...]: this rank's n rows (of an even split)
    with ``halo`` rows of its ring neighbours on each side, wrapping around
    (periodic). Its backward adds each halo row's gradient into the
    neighbour's edge row it came from."""
    axis = axis or current()
    rows = axis.size * x.shape[2]  # an even split
    needs = [(lo - halo, hi + halo) for lo, hi in
             (part(rows, axis.size, q) for q in range(axis.size))]
    return fetch_rows(x, rows, needs, True, axis)


def sharded_conv2d_same_circular(x, weight, axis=None):
    """A SAME, circularly padded 2D conv of ``x`` [b, ci, local rows, Y]
    (rows split evenly over the axis) with ``weight`` [co, ci, kx, ky]:
    the halo of the split axis from the neighbours, the other axis wrapped
    locally, then a valid conv."""
    kx, ky = weight.shape[2:]
    hx, hy = (kx - 1) // 2, (ky - 1) // 2
    x = halo_exchange(x, hx, axis)
    x = torch.nn.functional.pad(x, (hy, hy, 0, 0), mode="circular")
    return torch.nn.functional.conv2d(x, weight)


def sharded_spectral_rows_transform(x, c1, s1, axis=None):
    """The truncated row-mode DFT of ``x`` [b, local rows, m2, c]: each rank
    contracts its rows with its rows of the factors ``c1``, ``s1`` [local
    rows, 2*m1], and the partial mode sums are summed over the axis.
    Returns (re, im) [b, 2*m1, m2, c] on every rank."""
    re = torch.einsum("bxmc,xk->bkmc", x, c1)
    im = -torch.einsum("bxmc,xk->bkmc", x, s1)
    return spatial_sum(re, axis), spatial_sum(im, axis)


def check(model, k, config):
    """:func:`check_model` at the grid of ``config`` (the trainer's hook of
    each regime: ``check``, ``setup``, ``partial_params``)."""
    check_model(model, int(config.super_resolution[1]), k)


def setup(model, axis, config=None):
    """No weight is split on the x axis (returns None)."""


def partial_params(model):
    """Every parameter of a row-split model (each x rank holds a share of
    every gradient); none of a model that runs whole on each x rank."""
    return [] if whole(model) else list(model.parameters())


def whole(model):
    """Why ``model`` runs whole on each x rank, or None where its fields
    split over the rows. The MP-GNN's graph and the 1D fields have no
    row axis the port splits: as the JAX package's ``GridBatchSharding``
    leaves such arrays on the data axis, every x rank then holds the whole
    field, computes the whole step, and its gradients are summed over the
    data group alone."""
    if getattr(model, "data_structure", "grid") == "graph":
        return "the MP-GNN (a graph)"
    if getattr(model, "num_spatial_dims", 2) == 1:
        return "a 1D model"
    return None


def check_model(model, rows, k):
    """Raise unless ``model`` runs over an x axis of ``k`` ranks on a grid
    of ``rows`` rows: for a row-split model (every 2D and 3D grid family),
    rows that do not split evenly at every level of a U-Net (``ValueError``:
    rows % (k * 2^levels), no quiet fallback); ``rows`` None checks the
    family alone. A model that runs whole on each x rank (:func:`whole`)
    passes at any rows."""
    from nps_tpu_torch.models.unet_modern import Downsample

    if whole(model):
        return
    levels = max([0] + [sum(isinstance(b, Downsample) for b in m.down)
                        for m in model.modules() if hasattr(m, "down")])
    if rows is not None and rows % (k * 2 ** levels):
        raise ValueError(
            f"spatial_parallel={k}: the grid's {rows} rows do not split "
            f"over {k} ranks at each of the U-Net's 2^{levels} levels "
            f"(rows % {k * 2 ** levels} != 0)")
