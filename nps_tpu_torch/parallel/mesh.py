"""The data-parallel world over ``torch.distributed`` (counterpart of
``nps_tpu/parallel/mesh.py``).

The JAX package builds a 1-D ``("data",)`` mesh over the devices and lets
XLA insert the gradient all-reduce inside the jitted step. The port runs
one process per device instead, joined by a ``torch.distributed`` process
group: the world's size is the data extent, each rank holds a replica of
the parameters (:func:`replicate` broadcasts rank 0's), trains on its slice
of every global batch, and the trainer sums what the global batch needs
with the collectives below.

Only two collectives are used, ``all_reduce`` and ``broadcast``: they are
what the ``gloo`` backend carries for CUDA tensors, so the same code runs a
world of two ranks sharing one card under gloo and N cards under NCCL
(which refuses two ranks on one device).

Spatial, tensor, pipeline and expert parallelism (``--trainer.
spatial_parallel``, ``tensor_parallel``, ``pipeline_parallel``,
``expert_parallel`` = K) lay the world out as the JAX package's
``make_grid_mesh`` and ``make_dp_*_mesh`` lay out its devices: a (data,
axis) grid of D x K processes, rank = d * K + s (:class:`Grid`), whose
second axis is named ``x``, ``model``, ``pipe`` or ``expert``. Rank (d, s)
holds data slice d of every global batch; on the x axis also rows [s X /
K, (s + 1) X / K) of the first spatial axis X of every field
(:meth:`Grid.shard_batch`, the JAX package's ``GridBatchSharding`` role
table), but for a model with no row axis to split (the MP-GNN, a 1D
model: ``Grid.whole``), whose x ranks each hold the whole field, as
``GridBatchSharding`` leaves such arrays on the data axis.

The optimizer sums each parameter's gradient over the group its tag names
(:class:`GradSums`): over the data group where every rank of the axis
group holds the whole gradient of the parameter, or of its own shard
(``whole``), and over the world where each axis rank holds a part that the
others' complete (``partial``: every parameter under a row split, a
pipeline stage, the expert gate). Plain data parallelism sums everything
over the world.
"""

import os

import torch
import torch.distributed as dist

from nps_tpu_torch.parallel.spatial import SpatialAxis


def init_distributed(init_method="env://", world_size=None, rank=None,
                     backend=None, device="cuda", timeout=None):
    """Join the process group and return this rank's device.

    ``init_method`` is ``env://`` (a launcher's ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT``, as ``torchrun`` sets them) or
    ``tcp://host:port`` with an explicit ``world_size`` and ``rank``. The
    backend is the caller's, else the device's default: ``nccl`` on CUDA,
    ``gloo`` on the CPU. A CUDA rank's device is ``cuda:LOCAL_RANK``, or
    its rank modulo the device count where no launcher set ``LOCAL_RANK``.
    ``timeout`` (seconds) bounds every collective.

    Re-raises on failure: a misconfigured launch must die loudly, not train
    alone. Only re-entry into an initialised group returns quietly."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_distributed: no CUDA device is available; "
                           "pass device='cpu' for a CPU world over gloo")
    if not dist.is_initialized():
        kw = {}
        if world_size is not None:
            kw.update(world_size=int(world_size), rank=int(rank))
        if timeout is not None:
            from datetime import timedelta

            kw["timeout"] = timedelta(seconds=float(timeout))
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        try:
            dist.init_process_group(backend=backend, init_method=init_method,
                                    **kw)
        except Exception as e:
            print(f"[nps_tpu_torch] init_process_group({backend!r}, "
                  f"{init_method!r}) FAILED: {e!r}")
            raise
    if device.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        index = (int(local) if local is not None
                 else dist.get_rank() % torch.cuda.device_count())
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    return device


def world():
    """(rank, size) of the initialised process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def replicate(module, src=0):
    """Broadcast ``src``'s parameters and buffers into every rank's
    ``module`` (the JAX ``replicate``: one copy of the weights per device)."""
    if world()[1] == 1:
        return module
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src=src)
    return module


def all_reduce_(tensors, op=None, group=None, size=None):
    """Sum (or reduce by ``op``) ``tensors`` over the world (or ``group``
    of ``size`` ranks), in place, through one flat buffer per dtype; a
    no-op in a group of one."""
    tensors = [t for t in tensors if t is not None and t.numel()]
    if (world()[1] if group is None else size) == 1 or not tensors:
        return tensors
    op = dist.ReduceOp.SUM if op is None else op
    # dtypes in the order of first appearance: the same on every rank
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, op=op, group=group)
        parts = flat.split([t.numel() for t in same])
        torch._foreach_copy_(same, [p.view(t.shape)
                                    for p, t in zip(parts, same)])
    return tensors


class _GlobalSum(torch.autograd.Function):
    """All-reduce (sum) whose backward passes the gradient through: each
    rank's gradient is then its own share of the world's gradient, and the
    optimizer's all-reduce of the parameter gradients sums the shares."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def global_sum(x, group=None, size=None):
    """``x`` summed over the world (or ``group`` of ``size`` ranks), with
    this rank's gradient path (see :class:`_GlobalSum`); ``x`` itself in a
    group of one."""
    if (world()[1] if group is None else size) == 1:
        return x
    return _GlobalSum.apply(x, group)


def gather_rows(x, dim=0, group=None, index=None, size=None):
    """Every rank's ``x`` (the same shape on each) concatenated in rank
    order along ``dim``, on every rank (an all-reduce of a zero-padded
    buffer). The ranks are the world's, or ``group``'s with this rank's
    ``index`` in it and its ``size``."""
    if group is None:
        index, size = world()
    if size == 1:
        return x
    buf = x.new_zeros((size, *x.shape))
    buf[index] = x
    dist.all_reduce(buf, group=group)
    return torch.cat(buf.unbind(0), dim=dim)


# the axis of the first spatial dim X per position of the batch tuple
# (u_base, u_super, x, cond, t_cond, spatial_cond[, lengths]); None: a
# vector, split on the batch only (``nps_tpu/parallel/mesh.py``)
_SPATIAL_AXIS = (3, 3, 1, None, None, 2, None)


class Grid:
    """The (data, axis) grid of the world for an axis of K ranks (``name``:
    ``x`` for ``spatial_parallel``, ``model``, ``pipe`` or ``expert``): D =
    world / K data slices of K ranks each, rank = d * K + s. Every rank
    creates every group, in the same order: the axis group of each data
    slice (:attr:`axis`, a
    :class:`~nps_tpu_torch.parallel.spatial.SpatialAxis`: its group, K and
    s) and the data group of each axis index (:attr:`data_group`)."""

    def __init__(self, k, name="x", whole=None):
        from nps_tpu_torch.parallel.multihost import validate_grid_layout

        self.rank, size = world()
        k = int(k)
        validate_grid_layout(size, k, name)
        self.name = name
        # on the x axis: why the model runs whole on each x rank
        # (``spatial.whole``), or None where its fields split over the rows
        self.whole = whole
        self.split = name == "x" and not whole
        self.data_size = size // k
        self.data_index, s = divmod(self.rank, k)
        axis_groups = [dist.new_group(list(range(d * k, (d + 1) * k)))
                       for d in range(self.data_size)]
        data_groups = [dist.new_group(list(range(i, size, k)))
                       for i in range(k)]
        self.axis = SpatialAxis(axis_groups[self.data_index], k, s,
                                name=name)
        self.data_group = data_groups[s]

    def sum_group(self):
        """(group, size) of the step's sums over the batch: the world on
        a row split, whose ranks each hold a share of every element's
        cells; the data group otherwise, whose axis ranks hold the same
        values."""
        if self.split:
            return None, self.data_size * self.axis.size
        return self.data_group, self.data_size

    def broadcast_in_data(self, tensors):
        """Data slice 0's ``tensors`` (this rank's axis index) on every
        data slice: the replication of a shard over its data group."""
        if self.data_size == 1:
            return
        for t in tensors:
            if t.numel():
                dist.broadcast(t, src=self.axis.index, group=self.data_group)

    def shard_batch(self, batch):
        """This rank's rows of every field of the batch tuple (numpy arrays
        or tensors: the fields, ``pos`` and ``spatial_cond``; the vectors
        whole), as views; the batch itself for a model that runs whole on
        each x rank. A field whose rows do not split over K raises: no rank
        may hold another slice than the one its peers assume."""
        if not self.split:
            return tuple(batch)
        out = []
        for i, a in enumerate(batch):
            ax = _SPATIAL_AXIS[i] if i < len(_SPATIAL_AXIS) else None
            if (a is None or ax is None or a.ndim < 4
                    or ax >= a.ndim - 1):
                out.append(a)
                continue
            self.axis.check(a.shape[ax], f"batch entry {i}")
            lo, hi = self.axis.part(a.shape[ax])
            out.append(a[(slice(None),) * ax + (slice(lo, hi),)])
        return tuple(out)

    def gather_frames(self, x):
        """Frames [b, c, t, local rows, Y] of this rank -> the data slice's
        whole frames (rows gathered in the x group of a row split; else
        every rank holds them whole), then every data slice's in order
        along the batch: [D * b, c, t, X, Y]."""
        if self.split:
            x = self.gather_x(x)
        return gather_rows(x, 0, self.data_group, self.data_index,
                           self.data_size)

    def gather_x(self, x, dim=3):
        """This rank's rows of ``x`` (along ``dim``) -> the x group's whole
        field, on every rank of the group."""
        return gather_rows(x, dim, self.axis.group, self.axis.index,
                           self.axis.size)


class GradSums:
    """Which group each parameter's gradient is summed over: entries of
    (group, size, parameters, partial), group None for the world.
    :meth:`world` sums every parameter over the world (plain data
    parallelism). A grid's trainer puts each parameter whose gradient is
    whole on each axis rank in an entry of the data group, and each whose
    gradient is partial there (each axis rank holds a part of it) in a
    ``partial`` entry of the world, where a rank that has no gradient for
    it (a pipeline stage's, on the ranks that do not run it) adds zeros:
    the same tensors are then summed on every rank, with no agreement at
    run time."""

    def __init__(self, entries):
        self.entries = [(g, int(n), list(ps), bool(partial))
                        for g, n, ps, partial in entries]
        self._size = {id(p): n for _, n, ps, _ in self.entries for p in ps}

    @classmethod
    def world(cls, params):
        return cls([(None, world()[1], params, False)])

    def size_of(self, p):
        """The number of ranks ``p``'s gradient is summed over."""
        return self._size[id(p)]

    def reduce_(self, params, tensors):
        """Sum ``tensors`` (one per parameter of ``params``, or None) in
        place, each over its parameter's group, and return them (a
        partial entry's None as zeros)."""
        by_id = {id(p): t for p, t in zip(params, tensors, strict=True)}
        for group, size, ps, partial in self.entries:
            if partial and size > 1:
                for p in ps:
                    if by_id.get(id(p)) is None:
                        by_id[id(p)] = torch.zeros_like(p)
            all_reduce_([by_id.get(id(p)) for p in ps], group=group,
                        size=size)
        return [by_id.get(id(p)) for p in params]


def sum_grads_(sums, params):
    """Every parameter's ``.grad`` summed over its group (``sums``)."""
    grads = sums.reduce_(params, [p.grad for p in params])
    for p, g in zip(params, grads):
        if p.grad is None:
            p.grad = g


class AllReduceGrads:
    """The optimizer of data parallelism: ``step`` sums every parameter's
    gradient over its group (``sums``, a :class:`GradSums`; the world by
    default: the JAX step's gradient all-reduce), then steps ``inner``.
    The parameter groups are the inner optimizer's, so
    ``set_learning_rate`` and ``MultiSteps`` reach them."""

    def __init__(self, inner, sums=None):
        self.inner = inner
        self.world = world()[1]
        self.sums = sums or GradSums.world(self._params())

    def _params(self):
        return [p for g in self.inner.param_groups for p in g["params"]]

    @property
    def param_groups(self):
        return self.inner.param_groups

    def zero_grad(self, set_to_none=True):
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self):
        sum_grads_(self.sums, self._params())
        self.inner.step()

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, state):
        self.inner.load_state_dict(state)
