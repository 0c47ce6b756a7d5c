"""Expert parallelism: the experts of the mixture of spectral experts
split over the ranks of an expert group (counterpart of
``nps_tpu/parallel/expert.py``).

The JAX package stacks each block's experts on a leading ``n_experts``
axis, places it on the "expert" mesh axis and lets GSPMD partition the
vmapped experts and turn the gate contraction into a psum. The port holds
experts [r E / K, (r + 1) E / K) of every block of
:class:`~nps_tpu_torch.models.moe_fno.MoEFNO` on rank r of the expert axis
(the other experts' parameters are empty there), and under
``parallel.scope`` of an expert axis a block runs its local experts (K1
once each), sums their gated terms in f32 and sums that partial mixture
over the expert group (:func:`expert_sum`, an all-reduce whose backward
passes the gradient through, as ``parallel.mesh.global_sum``'s). The
block's input, and its conditioning (the vector the gate reads and its
broadcast to the grid, which the experts read: a BC encoder's code is in
both), enter the block through ``parallel.tensor.copy_in``, whose backward
sums their gradients over the expert group: each rank's experts, and the
gate's columns they read, give only their part of them.

The gate is replicated and runs on every rank; its gradient is partial
there (dL/dg[:, e] exists only where expert e lives), so it is summed over
the expert group as well as the data group (:func:`partial_params`). The
encoder's, a BC encoder's, the decoder's and the experts' gradients are
whole on each rank and are summed over the data group only.
"""

from nps_tpu_torch.parallel import spatial
from nps_tpu_torch.parallel.mesh import global_sum


def current():
    """The expert axis of the model apply in progress
    (``parallel.scope``), or None."""
    return spatial.current("expert")


def _moe_blocks(model):
    from nps_tpu_torch.models.moe_fno import MoEFNO

    return [(prefix, m) for prefix, m in model.named_modules()
            if isinstance(m, MoEFNO)]


def partition_specs(model, k):
    """{parameter name: the expert-axis rank that holds it, or None
    (replicated)}: expert e of every block on rank e // (E / K). An expert
    count that ``k`` does not divide raises (JAX's ``ValueError``: the
    experts would otherwise run K times over while they look split)."""
    owners = {}
    for prefix, moe in _moe_blocks(model):
        for i, experts in enumerate(moe.experts):
            n = len(experts)
            if n % k:
                raise ValueError(
                    f"expert_parallel={k} does not divide the expert stack "
                    f"axis of '{prefix}.experts.{i}' ({n} experts); set "
                    f"model.n_experts to a multiple of expert_parallel")
            for e, layer in enumerate(experts):
                for name, _ in layer.named_parameters():
                    key = f"{prefix}.experts.{i}.{e}.{name}"
                    owners[key.lstrip(".")] = e // (n // k)
    return {key: owners.get(key) for key, _ in model.named_parameters()}


def setup(model, axis, config=None):
    """The specs of ``model`` on the expert axis ``axis`` (the trainer then
    loads this rank's share, :func:`shard_state`)."""
    return partition_specs(model, axis.size)


def partial_params(model):
    """The parameters whose gradient is partial on an expert rank: every
    block's gate."""
    return [p for _, moe in _moe_blocks(model) for p in moe.gate.parameters()]


def shard_state(state, axis, specs):
    """This expert rank's share of a whole ``state_dict``: the experts it
    holds, and empty tensors for the others."""
    return {key: t if specs.get(key) in (None, axis.index) else t.new_empty(0)
            for key, t in state.items()}


def merge(shares, spec):
    """The whole tensor from every expert rank's (``shares``, in rank
    order; ``spec`` the rank that holds it, or None: replicated): the
    holder's, bit for bit."""
    return shares[0 if spec is None else spec]


def expert_sum(acc, axis):
    """The partial mixture ``acc`` summed over the expert group; its
    backward passes the gradient through."""
    return global_sum(acc, axis.group, axis.size)


def check(model, k, config=None):
    """Raise unless ``model`` has a mixture of experts whose expert count
    ``k`` divides (``ValueError``)."""
    if not _moe_blocks(model):
        raise ValueError(
            f"expert_parallel={k} splits the experts of a mixture of "
            f"spectral experts (MoEFNO); {type(model).__name__} has none")
    partition_specs(model, k)
