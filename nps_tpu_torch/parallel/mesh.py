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

Spatial parallelism (``--trainer.spatial_parallel=K``) lays the world out
as the JAX package's ``make_grid_mesh`` lays out its devices: a (data, x)
grid of D x K processes, rank = d * K + s (:class:`Grid`). Rank (d, s) holds
data slice d of every global batch and rows [s X / K, (s + 1) X / K) of the
first spatial axis X of every field (:meth:`Grid.shard_batch`, the JAX
package's ``GridBatchSharding`` role table).
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


def all_reduce_(tensors, op=None):
    """Sum (or reduce by ``op``) ``tensors`` over the world, in place,
    through one flat buffer per dtype; a no-op in a world of one."""
    tensors = [t for t in tensors if t is not None]
    if world()[1] == 1 or not tensors:
        return tensors
    op = dist.ReduceOp.SUM if op is None else op
    # dtypes in the order of first appearance: the same on every rank
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        group = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, op=op)
        parts = flat.split([t.numel() for t in group])
        torch._foreach_copy_(group, [p.view(t.shape)
                                     for p, t in zip(parts, group)])
    return tensors


class _GlobalSum(torch.autograd.Function):
    """All-reduce (sum) whose backward passes the gradient through: each
    rank's gradient is then its own share of the world's gradient, and the
    optimizer's all-reduce of the parameter gradients sums the shares."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad


def global_sum(x):
    """``x`` summed over the world, with this rank's gradient path (see
    :class:`_GlobalSum`); ``x`` itself in a world of one."""
    return x if world()[1] == 1 else _GlobalSum.apply(x)


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
    """The (data, x) grid of the world for ``spatial_parallel`` = K: D =
    world / K data slices of K ranks each, rank = d * K + s. Every rank
    creates every group, in the same order: the x group of each data slice
    (:attr:`axis`, a :class:`~nps_tpu_torch.parallel.spatial.SpatialAxis`)
    and the data group of each x index (:attr:`data_group`)."""

    def __init__(self, spatial_parallel):
        from nps_tpu_torch.parallel.multihost import validate_grid_layout

        self.rank, size = world()
        k = int(spatial_parallel)
        validate_grid_layout(size, k)
        self.data_size = size // k
        self.data_index, s = divmod(self.rank, k)
        x_groups = [dist.new_group(list(range(d * k, (d + 1) * k)))
                    for d in range(self.data_size)]
        data_groups = [dist.new_group(list(range(i, size, k)))
                       for i in range(k)]
        self.axis = SpatialAxis(x_groups[self.data_index], k, s)
        self.data_group = data_groups[s]

    def shard_batch(self, batch):
        """This rank's rows of every field of the batch tuple (numpy arrays
        or tensors: the fields, ``pos`` and ``spatial_cond``; the vectors
        whole), as views. A field whose
        rows do not split over K raises: no rank may hold another slice
        than the one its peers assume."""
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
        whole frames (rows gathered in the x group), then every data
        slice's in order along the batch: [D * b, c, t, X, Y]."""
        x = gather_rows(x, 3, self.axis.group, self.axis.index,
                        self.axis.size)
        return gather_rows(x, 0, self.data_group, self.data_index,
                           self.data_size)


class AllReduceGrads:
    """The optimizer of plain data parallelism: ``step`` sums every
    parameter's gradient over the world (the JAX step's gradient
    all-reduce), then steps ``inner``. The parameter groups are the inner
    optimizer's, so ``set_learning_rate`` and ``MultiSteps`` reach them."""

    def __init__(self, inner):
        self.inner = inner
        self.world = world()[1]

    @property
    def param_groups(self):
        return self.inner.param_groups

    def zero_grad(self, set_to_none=True):
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self):
        all_reduce_([p.grad for g in self.param_groups for p in g["params"]])
        self.inner.step()

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, state):
        self.inner.load_state_dict(state)
