"""ZeRO-1: the optimizer state sharded over the data-parallel world
(counterpart of ``nps_tpu/parallel/zero.py``).

Under plain data parallelism every rank holds Adam's two moments for every
parameter, twice the parameter bytes. ZeRO-1 (Rajbhandari et al. 2020)
gives each rank the moments of about 1/N of them. The JAX package places
the moments with a ``PartitionSpec`` that splits each tensor on its first
axis the data extent divides; the port takes
``torch.distributed.optim.ZeroRedundancyOptimizer``, which gives each rank
whole tensors (sorted by size, each to the rank holding the fewest
elements so far), steps the optimizer over them and broadcasts each
updated tensor from its owner. Adam, AdamW and SGD are elementwise, so
both splits give the unsharded update.

Enable with ``--trainer.zero1=true`` together with
``--trainer.data_parallel=true``; without data parallelism it is refused,
as in the JAX package.
"""

import torch
from torch.distributed.optim import ZeroRedundancyOptimizer

from nps_tpu_torch.parallel.mesh import GradSums, sum_grads_


class Zero1(ZeroRedundancyOptimizer):
    """The optimizer of ZeRO-1 data parallelism over the process group:
    ``Zero1(params, optimizer_class, **hyperparameters)``.

    ``step`` sums every parameter's gradient over its group (``sums``, a
    :class:`~nps_tpu_torch.parallel.mesh.GradSums`; the world by default:
    the JAX step's gradient all-reduce), steps this rank's share and
    broadcasts it. ``param_groups`` hold every parameter, so ``set_learning_rate``
    and ``MultiSteps`` see it as an unsharded optimizer. ``state_dict`` is
    a collective (every rank calls it): it returns the whole state in the
    unsharded optimizer's format on rank 0, where checkpoints are written,
    and None on the others; ``load_state_dict`` takes such a state on
    every rank and keeps this rank's share, so a checkpoint moves between
    ZeRO-1 and plain data parallelism."""

    def __init__(self, params, optimizer_class, sums=None, **kwargs):
        super().__init__(params, optimizer_class, **kwargs)
        self.sums = sums or GradSums.world(self._params())

    def _params(self):
        return [p for g in self.param_groups for p in g["params"]]

    @property
    def world(self):
        return self.world_size

    @torch.no_grad()
    def step(self, closure=None):
        sum_grads_(self.sums, self._params())
        return super().step(closure)

    def state_dict(self):
        self.consolidate_state_dict(to=0)
        return super().state_dict() if self.rank == 0 else None

    def load_state_dict(self, state):
        super().load_state_dict(state)
        # the base class also keeps this rank's share in ``self.state``,
        # a second copy on the device that nothing reads: drop it
        self.state.clear()


def state_bytes(optimizer):
    """Bytes of the optimizer state this rank holds (through
    ``MultiSteps`` and the data-parallel wrappers, the innermost
    optimizer's; under ZeRO-1 its local optimizer's)."""
    while hasattr(optimizer, "inner"):
        optimizer = optimizer.inner
    optimizer = getattr(optimizer, "optim", optimizer)
    return sum(v.numel() * v.element_size()
               for st in optimizer.state.values()
               for v in st.values() if torch.is_tensor(v))
