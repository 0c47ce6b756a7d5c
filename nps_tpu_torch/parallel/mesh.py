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
(which refuses two ranks on one device). The spatial mesh
(``make_grid_mesh``, ``GridBatchSharding``) belongs to spatial parallelism,
ROADMAP P9b item 3, and is not ported.
"""

import os

import torch
import torch.distributed as dist


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


def gather_rows(x):
    """Every rank's ``x`` [b, ...] (the same shape on each) stacked in rank
    order along dim 0: [world * b, ...], on every rank (an all-reduce of a
    zero-padded buffer)."""
    rank, size = world()
    if size == 1:
        return x
    buf = x.new_zeros((size, *x.shape))
    buf[rank] = x
    dist.all_reduce(buf)
    return buf.reshape(size * x.shape[0], *x.shape[1:])


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
