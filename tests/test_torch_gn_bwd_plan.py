"""The plan of GN+GELU's backward kernel (``ops/group_norm.py:gn_bwd_plan``,
``gn_bwd_tickets``: the Python side of ``gn1_bwd_ticket`` in
``csrc/gn1_gelu.cu``), checked on the CPU at the train steps' shapes and at
the odd and batch-1 shapes the card tests take, with the kernel's CTAs run
as a model (``schedule``) with one, a few or the card's CTAs resident: every plane in one sums and one
apply item of its own sample, each apply item after its sample's sums, the
applies in the reverse order of the sums, no stall, one sample of
lookahead, the L2 hints from the sample's bytes, the grid, the workspace,
the route by the sample's bytes. Then the plan
carried out step by step in plain PyTorch, in the model's order, against
the TPU side's backward (``tools/pallas_group_norm_evidence.py:_gn_bwd``)
and against ``jax.vjp`` of ``GroupNormFast`` + GELU; and the wrapper's
refusals. No GPU.

The card runs the same plans: ``tests/test_torch_cuda.py::
test_gn1_bwd_kernel_runs_every_item_once`` reads the counters a call
leaves.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nps_tpu.models.activations import GELU as JaxGELU
from nps_tpu.models.common import GroupNormFast
from nps_tpu_torch.ops import group_norm as gn

ROOT = Path(__file__).resolve().parents[1]
# the H100's L2 (cudaDevAttrL2CacheSize) and SMs; the resident CTAs of the
# kernel are SMs x its occupancy, which the build decides: a few of each
L2 = 50 * 2 ** 20
RESIDENT = [132 * 4, 132 * 8]
F32, BF16 = 4, 2
# (shape, bytes an element): the twophase train step's GroupNorm inputs (the
# U-FNO's largest, the time-conditioned one, the U-Net's largest and
# smallest), ns512's largest, middle and smallest (bf16), and the card
# tests' odd and batch-1 shapes in both types
SHAPES = ([((16, 388, 100, 68), F32), ((16, 396, 100, 68), F32),
           ((16, 132, 130, 98), F32), ((16, 256, 9, 5), F32),
           ((8, 260, 526, 526), BF16), ((8, 132, 263, 263), BF16),
           ((8, 128, 125, 125), BF16)]
          + [(s, e) for s in ((5, 7, 13, 11), (16, 64, 9, 5),
                              (1, 388, 100, 68), (64, 8, 16, 16),
                              (48, 72, 15, 15), (1, 128, 125, 125),
                              (2, 132, 263, 263), (2, 260, 526, 526))
             for e in (F32, BF16)])
IDS = [f"{'x'.join(map(str, s))}-{'f32' if e == F32 else 'bf16'}"
       for s, e in SHAPES]


def _plan(shape, itemsize, resident):
    b, c = shape[:2]
    return gn.gn_bwd_plan(b, c, int(np.prod(shape[2:])), itemsize, resident,
                          L2)


def _cases():
    return [pytest.param(s, e, r, id=f"{i}-{r}")
            for (s, e), i in zip(SHAPES, IDS) for r in RESIDENT]


def schedule(plan, b, ctas):
    """gn1_bwd_ticket's CTAs as a model, ``ctas`` of them resident in lock
    step, every item one step long: a CTA takes the next ticket when it
    starts (``gn_bwd_tickets``); an apply item runs once its sample's sums
    items are all done, and waits in its slot until then. Returns the items
    in the order they finish, as (apply, sample, item); raises if no
    resident CTA can run (a deadlock)."""
    tickets, nxt = gn.gn_bwd_tickets(plan, b), 0
    slots, done, log = [None] * ctas, [0] * b, []
    while nxt < len(tickets) or any(slots):
        for i in range(ctas):
            if slots[i] is None and nxt < len(tickets):
                slots[i], nxt = tickets[nxt], nxt + 1
        step = [i for i, it in enumerate(slots)
                if it and (it[0] == 0 or done[it[1]] == plan.items)]
        if not step:
            raise AssertionError("no resident CTA can run: the kernel stalls")
        for i in step:
            log.append(slots[i])
            slots[i] = None
        for apply, s, _ in log[-len(step):]:
            done[s] += apply == 0
    return log


def _log(shape, itemsize, resident, ctas=None):
    plan = _plan(shape, itemsize, resident)
    return plan, schedule(plan, shape[0], ctas or resident)


@pytest.mark.parametrize("shape,itemsize,resident", _cases())
def test_every_plane_in_one_sums_and_one_apply_item_of_its_sample(
        shape, itemsize, resident):
    b, c = shape[:2]
    plan, log = _log(shape, itemsize, resident)
    for kind in (0, 1):
        seen = np.zeros((b, c), np.int64)
        for apply, s, item in log:
            if apply == kind:
                lo, hi = gn.gn_bwd_planes(plan, c, item)
                assert 0 <= lo < hi <= c
                seen[s, lo:hi] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("shape,itemsize,resident", _cases())
@pytest.mark.parametrize("ctas", [1, 3, None])
def test_apply_items_follow_their_samples_sums(shape, itemsize, resident,
                                               ctas):
    """An apply item starts only after its sample's sums items are all
    done, and the work ends on one CTA, a few, or the plan's grid: no CTA
    waits while it holds an item another needs."""
    b = shape[0]
    plan, log = _log(shape, itemsize, resident, ctas)
    last_sums = {s: t for t, (a, s, _) in enumerate(log) if a == 0}
    first_apply = {}
    for t, (a, s, _) in enumerate(log):
        if a == 1:
            first_apply.setdefault(s, t)
    assert sorted(first_apply) == list(range(b))
    assert all(last_sums[s] < first_apply[s] for s in range(b))


@pytest.mark.parametrize("shape,itemsize,resident", _cases())
def test_apply_order_reverses_sums_order(shape, itemsize, resident):
    b = shape[0]
    plan = _plan(shape, itemsize, resident)
    tickets = gn.gn_bwd_tickets(plan, b)
    for s in range(b):
        sums = [i for a, q, i in tickets if a == 0 and q == s]
        applies = [i for a, q, i in tickets if a == 1 and q == s]
        assert sums == list(range(plan.items))
        assert applies == sums[::-1]


@pytest.mark.parametrize("shape,itemsize,resident", _cases())
def test_lookahead_and_grid_follow_the_samples_bytes(shape, itemsize,
                                                     resident):
    """One sample of lookahead: sample s's applies follow sample s + 1's
    sums; the L2 hints where a sample's x and dy fit L2; one CTA a
    ticket."""
    b = shape[0]
    plan = _plan(shape, itemsize, resident)
    sample = 2 * itemsize * int(np.prod(shape[1:]))
    assert plan.hint == int(sample <= L2)
    assert plan.grid == len(gn.gn_bwd_tickets(plan, b))
    tickets = gn.gn_bwd_tickets(plan, b)
    for s in range(b):
        first_apply = tickets.index((1, s, plan.items - 1))
        ahead = {q for a, q, _ in tickets[:first_apply] if a == 0}
        assert ahead == set(range(min(b, s + 2)))


@pytest.mark.parametrize("shape,itemsize", SHAPES, ids=IDS)
def test_route_by_sample_bytes(shape, itemsize):
    """The three-kernel route for a sample of x and dy under BWD_THREE_BELOW
    bytes, gn1_bwd_ticket otherwise."""
    dtype = torch.float32 if itemsize == F32 else torch.bfloat16
    x = torch.empty(shape, dtype=dtype, device="meta")
    small = 2 * itemsize * int(np.prod(shape[1:])) < gn.BWD_THREE_BELOW
    assert gn.gn_bwd_route(x) == ("three" if small else "ticket")


@pytest.mark.parametrize("shape,itemsize,resident", _cases())
def test_items_are_sized_by_bytes(shape, itemsize, resident):
    """Whole planes of about BWD_ITEM_BYTES of x and dy, at most the
    kernel's 32 (kMaxPer); a warp a plane up to 2048 elements."""
    b, c = shape[:2]
    hw = int(np.prod(shape[2:]))
    plan = _plan(shape, itemsize, resident)
    plane = 2 * hw * itemsize
    assert plan.warp == int(hw <= gn.BWD_WARP_PLANE)
    assert 1 <= plan.per <= min(gn.BWD_MAX_PER, c)
    assert plan.items == -(-c // plan.per)
    assert plan.per == 1 or plan.per * plane <= gn.BWD_ITEM_BYTES
    if not plan.warp:
        assert plan.per == max(1, min(gn.BWD_MAX_PER, c,
                                      gn.BWD_ITEM_BYTES // plane))


def test_item_sizes_at_the_ns512_shapes():
    """A 526^2 plane stands alone and its sample does not fit L2 (no
    hints); a 125^2 one too, its sample in L2; a twophase sample fits L2,
    one plane an item."""
    small = _plan((8, 128, 125, 125), BF16, RESIDENT[1])
    large = _plan((8, 260, 526, 526), BF16, RESIDENT[1])
    assert small.per == 1 and small.hint
    assert large.per == 1 and not large.hint
    twophase = _plan((16, 388, 100, 68), F32, RESIDENT[1])
    assert twophase.hint and twophase.per == 1


@pytest.mark.parametrize("shape,itemsize,resident", _cases())
def test_workspace_covers_counters_and_flags(shape, itemsize, resident):
    """The int workspace: the ticket, samples published, then per sample its
    done count and its coef's state (the kernel's ctr + 2 + s and
    ctr + 2 + b + s)."""
    b = shape[0]
    plan = _plan(shape, itemsize, resident)
    assert plan.counters == 2 + 2 * b
    assert 2 + b + (b - 1) < plan.counters
    assert plan.grid < 2 ** 31


# ---- the plan carried out in plain PyTorch, against JAX's backward --------
def _pallas_module():
    spec = importlib.util.spec_from_file_location(
        "pallas_group_norm_evidence",
        ROOT / "tools" / "pallas_group_norm_evidence.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _carry_out(plan, x, w, bias, stats, dy, act):
    """gn1_bwd_ticket's steps in the order ``schedule`` finishes them with
    five CTAs resident: a sums item's per-plane sums into ws, its sample's coef once all
    its sums items are done (in channel order), an apply item's dx only
    after that; dgamma and dbeta summed over the samples. Raises if an
    apply item comes before its coef or a plane is written twice."""
    b, c = x.shape[:2]
    xf, dyf = x.reshape(b, c, -1).double(), dy.reshape(b, c, -1).double()
    mean = stats[:, 0, None].double()
    inv = stats[:, 1, None].double()
    ws = torch.zeros((b, c, 2), dtype=torch.float64)
    done, coef = [0] * b, [None] * b
    dx = torch.full_like(xf, float("nan"))

    def grads(s, p):
        xh = (xf[s, p] - mean[s]) * inv[s]
        pre = xh * w[p].double() + bias[p].double()
        if act:
            pre = pre.requires_grad_()
            g, = torch.autograd.grad(gn.F.gelu(
                pre, approximate=("none", "tanh")[act - 1]).sum(), pre)
            g = g * dyf[s, p]
        else:
            g = dyf[s, p]
        return g, xh

    for apply, s, item in schedule(plan, b, 5):
        lo, hi = gn.gn_bwd_planes(plan, c, item)
        for p in range(lo, hi):
            g, xh = grads(s, p)
            if apply:
                assert coef[s] is not None, "apply before its sample's sums"
                assert torch.isnan(dx[s, p]).all(), "plane written twice"
                dx[s, p] = inv[s] * (g * w[p] - coef[s][0] - xh * coef[s][1])
            else:
                ws[s, p] = torch.stack([g.sum(), (g * xh).sum()])
        if not apply:
            done[s] += 1
            if done[s] == plan.items:
                n = xf[s].numel()
                coef[s] = (w.double()[:, None] * ws[s]).sum(0) / n
    return dx.reshape(x.shape), ws[..., 1].sum(0), ws[..., 0].sum(0)


def _case(seed, shape):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    w = (1.0 + 0.2 * rng.standard_normal(shape[1])).astype(np.float32)
    bias = (0.1 * rng.standard_normal(shape[1])).astype(np.float32)
    return x, dy, w, bias


def _stats(x):
    xf = x.reshape(x.shape[0], -1).astype(np.float64)
    mean = xf.mean(1)
    var = np.maximum((xf * xf).mean(1) - mean * mean, 0.0)
    return np.stack([mean, 1.0 / np.sqrt(var + gn.EPS)], 1).astype(
        np.float32)


def _rel(a, ref):
    return float(np.abs(np.asarray(a) - np.asarray(ref)).max()
                 / np.abs(np.asarray(ref)).max())


# (shape, resident, L2 bytes, planes an item): small shapes whose plans
# take several items a sample, a warp or the CTA a plane
EMULATED = [((3, 12, 10, 8), 8, 10 ** 6, 2),
            ((4, 9, 7, 6), 4, 4000, 2),
            ((2, 6, 50, 50), 16, 10 ** 6, 2),
            ((5, 7, 13, 11), 132, 200, 7)]


def _emulated_plan(shape, resident, l2, per):
    b, c = shape[:2]
    plan = gn.gn_bwd_plan(b, c, int(np.prod(shape[2:])), F32, resident, l2)
    items = -(-c // per)
    return plan._replace(per=per, items=items, grid=2 * b * items)


@pytest.mark.parametrize("shape,resident,l2,item", EMULATED)
def test_plan_carried_out_matches_the_tpu_sides_backward(shape, resident,
                                                        l2, item):
    """Without the GELU the op is GroupNorm(1): the plan carried out against
    ``_gn_bwd`` of the TPU kernel's module (channels last there), dx,
    dgamma and dbeta at 1e-5."""
    plan = _emulated_plan(shape, resident, l2, item)
    assert plan.items > 1 or plan.warp
    x, dy, w, bias = _case(1, shape)
    stats = _stats(x)
    got = _carry_out(plan, *map(torch.from_numpy, (x, w, bias, stats, dy)),
                     act=0)
    mod = _pallas_module()
    nhwc = (0, 2, 3, 1)
    ref = mod._gn_bwd(gn.EPS, (jnp.asarray(x.transpose(nhwc)),
                               jnp.asarray(w), jnp.asarray(stats)),
                      jnp.asarray(dy.transpose(nhwc)))
    assert _rel(got[0].numpy(), np.asarray(ref[0]).transpose(0, 3, 1, 2)) \
        < 1e-5
    assert _rel(got[1].numpy(), ref[1]) < 1e-5
    assert _rel(got[2].numpy(), ref[2]) < 1e-5


@pytest.mark.parametrize("shape,resident,l2,item", EMULATED)
def test_plan_carried_out_with_gelu_matches_jax_vjp(shape, resident, l2,
                                                    item):
    """With the exact GELU: the plan carried out against ``jax.vjp`` of
    ``GroupNormFast(1)`` + ``nps_tpu``'s GELU, at 1e-4 (the ROADMAP's
    gradient bar is 5e-3)."""
    plan = _emulated_plan(shape, resident, l2, item)
    x, dy, w, bias = _case(2, shape)
    got = _carry_out(plan, *map(torch.from_numpy,
                                (x, w, bias, _stats(x), dy)), act=1)
    mod = GroupNormFast(num_groups=1)
    nhwc = (0, 2, 3, 1)

    def f(x, scale, b):
        return JaxGELU()(mod.apply({"params": {"scale": scale, "bias": b}},
                                   x))

    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(f, jnp.asarray(x.transpose(nhwc)), jnp.asarray(w),
                         jnp.asarray(bias))
        ref = vjp(jnp.asarray(dy.transpose(nhwc)))
    assert _rel(got[0].numpy(), np.asarray(ref[0]).transpose(0, 3, 1, 2)) \
        < 1e-4
    assert _rel(got[1].numpy(), ref[1]) < 1e-4
    assert _rel(got[2].numpy(), ref[2]) < 1e-4


# ---- the wrapper's refusals, on any device ------------------------------
def _args(shape=(2, 3, 4, 5), dtype=torch.float32):
    x = torch.randn(shape).to(dtype)
    dy = torch.randn(shape).to(dtype)
    c = shape[1]
    return x, torch.ones(c), torch.zeros(c), torch.zeros(shape[0], 2), dy


def test_wrapper_refuses_non_contiguous_input():
    x, w, b, stats, dy = _args()
    with pytest.raises(ValueError, match="contiguous"):
        gn.gn1_gelu_bwd(x.transpose(2, 3), w, b, stats, dy.transpose(2, 3))
    with pytest.raises(ValueError, match="contiguous"):
        gn.gn1_gelu_bwd(x, w, b, stats, dy.transpose(2, 3).contiguous()
                        .transpose(2, 3))


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.float32),
                                    (torch.float16, torch.float16)])
def test_wrapper_refuses_mixed_or_other_types(dtypes):
    x, w, b, stats, _ = _args(dtype=dtypes[0])
    dy = torch.randn(x.shape).to(dtypes[1])
    with pytest.raises(TypeError, match="f32 or bf16"):
        gn.gn1_gelu_bwd(x, w, b, stats, dy)


@pytest.mark.parametrize("stats", [torch.zeros(3, 2), torch.zeros(2, 3),
                                   torch.zeros(2, 2, dtype=torch.float64),
                                   torch.zeros(2, 4)[:, ::2]])
def test_wrapper_refuses_wrong_stats(stats):
    x, w, b, _, dy = _args()
    with pytest.raises(ValueError, match="stats"):
        gn.gn1_gelu_bwd(x, w, b, stats, dy)


def test_wrapper_refuses_cpu_tensors():
    """Well-formed CPU arguments: the wrapper never runs a plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        gn.gn1_gelu_bwd(*_args())
