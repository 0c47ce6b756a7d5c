"""Pipeline parallelism: GPipe microbatch streaming over the ranks of a pipe
group (counterpart of ``nps_tpu/parallel/pipeline.py``).

The processor chain of an ``EncProcDec`` is a homogeneous stack of stages
(:class:`StageSplit`, the JAX package's ``_StageSplit``):

- block mode: one processor (``UFNO``, ``DilatedResnet``, ``FNO``,
  ``MoEFNO``), one stage per internal block (the processor's ``block``),
  whatever the block holds (a U-FNO's mini U-Net with attention, 3D
  convs and spectral weights);
- processor mode: a list of identical processor specs (any processor, a
  ``UNetModern`` with attention too), one stage per processor, with
  ``processor_residual`` between them;
- a heterogeneous chain (FNO -> U-FNO) raises, and so does a pipe size
  that does not divide the stage count.

Pipe rank s of K holds stages [s S, (s + 1) S) (S = stages / K) of every apply.
The parameters are replicated, as in the JAX package: every rank holds all of
them, and runs only its stages. Under ``parallel.scope`` of a pipe axis the
model's processor runs :func:`run`, the GPipe tick loop (``_gpipe``): M + K - 1
ticks over M microbatches of the local batch, pipe rank s applying its stages
to microbatch t - s (bubble ticks compute nothing). The activation moves to the
next stage by :class:`_Shift`, a one-writer slot all-reduce (rank s writes slot
s + 1, reads slot s) whose backward is the reverse shift; every shift takes the
previous one's output as an input, so the shifts form one chain on every rank
and the backward runs them in the reverse order on all of them. The last
stage's outputs go to every pipe rank by a one-writer all-reduce
(:class:`_LastToAll`) whose backward passes only the rank's own cotangent: the
decoder after it is replicated, and a sum would give it K times.

The encoder and decoder run replicated on every pipe rank. The decoder's
gradient is whole on each of them (summed over the data group only); a
stage's comes from its owner alone, and the encoder's from pipe rank 0 (the
one that feeds it), so both are summed over the pipe group too, where only
one rank's is non-zero (:func:`partial_params`; a rank that holds no
gradient for one adds zeros). A BC encoder runs replicated too, in the
encoder's stage; its code reaches the encoder and every stage, each pipe
rank's share of its gradient coming from what that rank runs, so it is
summed over the pipe group as well (the grid decoders read no
conditioning, as in the JAX package, so none of it comes from the
replicated decoder). A local batch that microbatches do not tile runs
the sequential chain on every rank (the JAX package's remainder path),
behind :class:`_OwnerGrad`, which keeps that chain's gradient on pipe rank
0 alone for the same sums. Every collective is an ``all_reduce``, which
gloo carries for CUDA tensors (ranks sharing one card); it moves K times
the bytes of a send/receive pair (ROADMAP: NCCL ``send``/``recv``).
"""

from argparse import Namespace

import torch

from nps_tpu_torch.parallel import spatial
from nps_tpu_torch.parallel.mesh import world
from nps_tpu_torch.parallel.spatial import _exact_sum, _slot_buffer, traffic

# the processors that decompose into blocks (their ``block`` method)
BLOCK_PROCESSORS = ("UFNO", "DilatedResnet", "FNO", "MoEFNO")


def current():
    """The pipe axis of the model apply in progress (``parallel.scope``;
    its ``micro``: the microbatch count, 0: one sample each), or None."""
    return spatial.current("pipe")


def _spec_equal(a, b):
    def norm(s):
        return vars(s) if isinstance(s, Namespace) else s

    return norm(a) == norm(b)


class StageSplit:
    """How the processor chain of ``model`` (an ``EncProcDec``) splits into
    identical stages: ``mode`` "block" or "processor", ``n_stages``, and
    :meth:`apply` of one stage."""

    def __init__(self, model):
        if getattr(model, "data_structure", "grid") != "grid":
            raise ValueError(
                "pipeline_parallel supports grid models only; the MP-GNN "
                "shards over data instead (data_parallel=true)")
        specs = getattr(model, "processor_specs", None)
        if specs is None:
            raise NotImplementedError(
                f"pipeline parallelism pipelines an EncProcDec's processor "
                f"chain; {type(model).__name__} has none")
        self.model = model
        if len(specs) > 1:
            if any(not _spec_equal(s, specs[0]) for s in specs[1:]):
                raise ValueError(
                    "pipeline_parallel over a processor list requires all "
                    "processor specs to be identical (homogeneous stages); "
                    "heterogeneous chains (e.g. FNO->UFNO) cannot pipeline")
            self.mode, self.n_stages = "processor", len(specs)
            self.residual = bool(model.processor_residual)
        else:
            proc = model.processor[0]
            if type(proc).__name__ not in BLOCK_PROCESSORS:
                raise NotImplementedError(
                    f"no pipeline stage protocol for processor "
                    f"{type(proc).__name__}; supported: "
                    f"{sorted(BLOCK_PROCESSORS)} or a homogeneous processor "
                    f"list")
            self.mode, self.n_stages = "block", int(proc.hidden_blocks)
            self.residual = False

    def check(self, k):
        if self.n_stages % k:
            raise ValueError(
                f"pipeline_parallel={k} must divide the stage count "
                f"{self.n_stages} ({self.mode}-granularity)")

    def apply(self, g, h, variables, vb, pos):
        """Stage ``g`` (global index) on h."""
        m = self.model
        if self.mode == "block":
            return m.processor[0].block(g, h, variables=variables,
                                        variables_broadcast=vb, pos=pos)
        kwargs = dict(variables_broadcast=vb, pos=pos)
        if m._takes_variables[g]:
            kwargs["variables"] = variables
        h_next = m.processor[g](h, **kwargs)
        return h_next + h if (self.residual and g > 0) else h_next


def check(model, k, config=None):
    """Raise unless ``model`` pipelines over ``k`` ranks, and for a
    ``pipeline_microbatches`` that never divides the steady-state batch of
    a data slice: every batch would take the sequential remainder path."""
    StageSplit(model).check(k)
    n_micro = int(getattr(config, "pipeline_microbatches", 0) or 0)
    if not n_micro:
        return
    bs, n_data = int(config.batch_size), world()[1] // k
    if bs % n_data or (bs // n_data) % n_micro:
        raise ValueError(
            f"pipeline_microbatches={n_micro} never divides the "
            f"steady-state per-data-rank batch ({bs}/{n_data} data "
            f"ranks): every batch would fall back to the sequential "
            f"(unpipelined) apply. Pick batch_size/microbatches so that "
            f"(batch_size // {n_data}) % microbatches == 0")


def setup(model, axis, config=None):
    """Set the pipe axis's microbatch count from ``config``; no weight is
    split (returns None)."""
    axis.micro = int(getattr(config, "pipeline_microbatches", 0) or 0)


def partial_params(model):
    """The parameters whose gradient is partial on a pipe rank: the
    encoder's (pipe rank 0's), the processor chain's (each stage's
    owner's) and the BC encoder's (each rank's stages' share)."""
    bc = model.bc_encoder
    return [*model.encoder.parameters(), *model.processor.parameters(),
            *([] if bc is None else bc.parameters())]


class _Shift(torch.autograd.Function):
    """Rank s's ``out`` to rank s + 1; returns what rank s - 1 sent (zeros
    on rank 0). ``prev``, the previous shift's output, is read by nothing:
    it chains the shifts. The backward is the reverse shift."""

    @staticmethod
    def forward(ctx, out, prev, axis):
        ctx.axis = axis
        k, s = axis.size, axis.index
        flat, buf = _slot_buffer((k, *out.shape), out)
        if s + 1 < k:
            buf[s + 1] = out
        _exact_sum(flat, axis.group)
        traffic["shift"] += 1
        traffic["shift_bytes"] += flat.numel() * flat.element_size()
        return buf[s].clone()

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        flat, buf = _slot_buffer((axis.size, *g.shape), g)
        if axis.index >= 1:
            buf[axis.index - 1] = g
        _exact_sum(flat, axis.group)
        traffic["shift_bwd"] += 1
        return buf[axis.index].clone(), torch.zeros_like(g), None


class _LastToAll(torch.autograd.Function):
    """The last pipe rank's ``outs`` on every pipe rank (``last``, the final
    shift's output, chains it after the shifts); the backward passes the
    rank's own cotangent, unsummed."""

    @staticmethod
    def forward(ctx, outs, last, axis):
        ctx.last_shape = last.shape
        flat, buf = _slot_buffer(outs.shape, outs)
        if axis.index == axis.size - 1:
            buf.copy_(outs)
        _exact_sum(flat, axis.group)
        traffic["last_to_all"] += 1
        traffic["last_to_all_bytes"] += flat.numel() * flat.element_size()
        return buf

    @staticmethod
    def backward(ctx, g):
        return g, g.new_zeros(ctx.last_shape), None


class _OwnerGrad(torch.autograd.Function):
    """The identity, whose backward keeps the gradient on pipe rank 0 and
    gives zeros on the others."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.axis.index == 0 else torch.zeros_like(g)), None


def stage_split(model):
    """``model``'s :class:`StageSplit`, built on first use."""
    split = getattr(model, "_stage_split", None)
    if split is None:
        split = model._stage_split = StageSplit(model)
    return split


def run(model, h0, variables, vb, pos, axis):
    """The processor chain of ``model`` on h0 [b, C, *sp] (the encoder's
    output) pipelined over the pipe axis ``axis``; the last stage's output
    on every pipe rank."""
    split = stage_split(model)
    k, s = axis.size, axis.index
    split.check(k)
    b = h0.shape[0]
    n_micro = axis.micro or b
    if b % n_micro:
        # the remainder: the sequential chain, its gradient on rank 0 only
        h = h0
        for g in range(split.n_stages):
            h = split.apply(g, h, variables, vb, pos)
        return _OwnerGrad.apply(h, axis) if torch.is_grad_enabled() else h
    mb = b // n_micro
    per = split.n_stages // k

    def chunks(t):
        return [None] * n_micro if t is None else list(t.split(mb))

    h0m, vbm, posm, varm = chunks(h0), chunks(vb), chunks(pos), \
        chunks(variables)
    zeros = h0.new_zeros((mb, *h0.shape[1:]))
    # with gradients every rank's shifts join the graph from the first one
    state = zeros.clone().requires_grad_(torch.is_grad_enabled())
    outs = [None] * n_micro
    for t in range(n_micro + k - 1):
        m = t - s
        if 0 <= m < n_micro:
            h = h0m[m] if s == 0 else state
            for j in range(per):
                h = split.apply(s * per + j, h, varm[m], vbm[m], posm[m])
            if s == k - 1:
                outs[m] = h
        else:   # a bubble: nothing to compute, zeros to send
            h = zeros
        state = _Shift.apply(h, state, axis)
    mine = torch.cat(outs) if s == k - 1 else h0.new_zeros(h0.shape)
    return _LastToAll.apply(mine, state, axis)
