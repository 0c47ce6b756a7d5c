"""GroupNorm with f32 statistics, and GroupNorm(1 group)+GELU fused.

The fused op is the port of the TPU kernel K2
(``tools/pallas_group_norm_evidence.py``: ``_fwd_kernel`` / ``_run_fwd``),
extended by the GELU that follows every such norm in a U-Net
``ResidualBlock``: the exact-erf form (``approximate="none"``, ``GELU``) or
the tanh form (``approximate="tanh"``, ``GELUTanh``, as ``F.gelu`` spells
it; ``cfg_ns512_ufno``'s). Semantics, as in
``nps_tpu.models.common.GroupNormFast``: f32 statistics ``E[x]`` and
``E[x^2]``, ``var = max(E[x^2] - E[x]^2, 0)``, ``inv = rsqrt(var + eps)``,
eps 1e-5, then per-channel affine, then the GELU if ``gelu``.

Layout: NCHW (any number of spatial dims), contiguous; f32, or bf16 with f32
statistics and f32 arithmetic, rounded once on output. The statistics stay f32
inside a no-grad pushforward step under ``trainer.pushforward_fast`` too,
where the JAX package takes them in bf16 for bf16 inputs
(``nps_tpu/models/common.py``): f32 sums are the TPU kernel's own, cost the
kernel nothing extra, and keep the fast step within the bf16 bar against
JAX; only the exact GELU turns into the tanh form there
(``models/config.py:fast_forward_scope``). A CPU tensor takes
the plain version, a CUDA tensor the kernel ``gn1_gelu_fwd``
(``csrc/gn1_gelu.cu``); there is no fallback between them.

The kernel has two variants, chosen by the sample's size alone: the
persistent one (one read of x) for a sample that the resident grid's shared
memory holds, and ``gn1_gelu_fwd_stream`` (two reads of x, three launches)
for a larger one, such as a top-level U-Net norm of ``cfg_ns512_ufno``.
They count their launches under ``gn1_gelu_fwd`` and
``gn1_gelu_fwd_stream``.

Without gradients, :func:`gn_gelu` calls the custom op
``nps_torch::gn1_gelu_fwd`` (:mod:`nps_tpu_torch.ops.library`) on both
devices: the kernel on CUDA, the plain version on the CPU. Gradients: on
CUDA, :class:`GNGeluFn` pairs the forward kernel with the hand-written
backward ``gn1_gelu_bwd`` (f32 or bf16, with f32 sums and f32 weight
gradients), by the sample's bytes (:func:`gn_bwd_route`): one launch of
``gn1_bwd_ticket`` under the plan :func:`gn_bwd_plan` computes (items of
whole planes in ticket order, each sample's sums then its applies in the
reverse order), or for a sample under BWD_THREE_BELOW bytes three kernels
of one CTA a plane (:func:`launch_gn1_bwd_three`). On the CPU, autograd
runs through the plain version.
"""

import collections
import ctypes

import torch
import torch.nn.functional as F

from nps_tpu_torch import kernels

EPS = 1e-5


def group_norm_plain(x, num_groups, weight, bias, eps=EPS):
    """GroupNorm over [b, C, *sp] with f32 statistics; any group count.
    Returns f32."""
    b, c = x.shape[:2]
    g = num_groups
    if c % g:
        raise ValueError(f"{c} channels do not split into {g} groups")
    xg = x.float().reshape(b, g, -1)
    mean = xg.mean(dim=-1, keepdim=True)
    mean2 = (xg * xg).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(torch.clamp(mean2 - mean * mean, min=0.0) + eps)
    y = ((xg - mean) * inv).reshape(x.shape)
    aff = (1, c) + (1,) * (x.ndim - 2)
    return y * weight.float().reshape(aff) + bias.float().reshape(aff)


APPROXIMATE = ("none", "tanh")


def _act(gelu, approximate):
    """The kernels' activation code: 0 none, 1 GELU (erf), 2 GELU (tanh)."""
    if approximate not in APPROXIMATE:
        raise ValueError(f"approximate must be one of {APPROXIMATE}, got "
                         f"{approximate!r}")
    return 0 if not gelu else 1 + APPROXIMATE.index(approximate)


def gn_gelu_plain(x, weight, bias, gelu=True, eps=EPS, approximate="none"):
    """Plain version of the fused kernel: GroupNorm(1) then GELU (exact, or
    tanh-approximate), computed in f32 and rounded once to x's type."""
    _act(gelu, approximate)
    y = group_norm_plain(x, 1, weight, bias, eps)
    if gelu:
        y = F.gelu(y, approximate=approximate)
    return y.to(x.dtype)


_PLANS = {}
# elements per CTA of the streaming variant (a multiple of 8)
STREAM_CHUNK = 32768


def _plan(b, n, is_bf16):
    """The persistent kernel's launch plan for ``b`` samples of ``n``
    elements: (grid, samples per round, CTAs per sample, slice length,
    rounds, vector path), or None when a sample does not fit the grid's
    shared memory (the streaming variant takes it). Cached per shape."""
    key = (b, n, is_bf16)
    if key not in _PLANS:
        out = (ctypes.c_int * 6)()
        kernels.check(kernels.library().gn1_gelu_plan(b, n, int(is_bf16), out),
                      "gn1_gelu_plan")
        _PLANS[key] = tuple(out) if out[0] else None
    return _PLANS[key]


def gn1_gelu_fwd(x, weight, bias, gelu=True, eps=EPS, approximate="none"):
    """Launch the fused GroupNorm(1)+GELU kernel on a CUDA tensor."""
    return gn1_gelu_fwd_stats(x, weight, bias, gelu, eps, approximate)[0]


def _check_affine(x, weight, bias):
    c = x.shape[1]
    for name, p in (("weight", weight), ("bias", bias)):
        if (p.device != x.device or p.dtype != torch.float32
                or tuple(p.shape) != (c,) or not p.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous f32 [{c}] tensor "
                             f"on {x.device}")


def _check_sample_size(x):
    n = x[0].numel()
    if n >= 2 ** 31 - 2 ** 20:
        raise ValueError(f"a sample of {n} elements exceeds the kernel's "
                         "32-bit indexing")
    return n


def gn1_gelu_fwd_stats(x, weight, bias, gelu=True, eps=EPS,
                       approximate="none"):
    """:func:`gn1_gelu_fwd` that also returns the per-sample statistics the
    kernel writes, ``stats`` [b, 2] f32 (mean, inv), for the backward."""
    act = _act(gelu, approximate)
    if x.device.type != "cuda":
        raise ValueError(f"gn1_gelu_fwd takes CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gn1_gelu_fwd takes f32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("gn1_gelu_fwd takes a contiguous NCHW tensor")
    if x.ndim < 3:
        raise ValueError(f"expects [b, C, *sp], got shape {tuple(x.shape)}")
    b, c = x.shape[:2]
    _check_affine(x, weight, bias)
    hw = x[0, 0].numel()
    n = _check_sample_size(x)
    bf16 = x.dtype == torch.bfloat16
    plan = _plan(b, n, bf16)
    y = torch.empty_like(x)
    stats = torch.empty((b, 2), dtype=torch.float32, device=x.device)
    if plan is None:
        _launch_stream(x, weight, bias, y, stats, act, eps)
        return y, stats
    grid, spr, ctas, per, rounds, vec = plan
    # 16-byte copies need 16-byte aligned samples in and out
    vec = int(vec and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
    partials = torch.empty((b, ctas, 2), dtype=torch.float32, device=x.device)
    rc = kernels.library().gn1_gelu_fwd(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        stats.data_ptr(), partials.data_ptr(), b, c, hw, float(eps), act,
        int(bf16), grid, spr, ctas, per, rounds, vec,
        kernels.stream_ptr(x.device))
    kernels.check(rc, "gn1_gelu_fwd")
    kernels.launches["gn1_gelu_fwd"] += 1
    kernels.act_launches["gn1_gelu_fwd", act] += 1
    return y, stats


def _launch_stream(x, weight, bias, y, stats, act, eps):
    """The streaming variant into ``y`` and ``stats``: f32 partial sums over
    fixed chunks of each sample, their sum per sample in a fixed order,
    then the normalisation (x read twice)."""
    b, c = x.shape[:2]
    hw, n = x[0, 0].numel(), x[0].numel()
    chunks = -(-n // STREAM_CHUNK)
    per_vec = 16 // x.element_size()
    vec = int(n % per_vec == 0 and x.data_ptr() % 16 == 0
              and y.data_ptr() % 16 == 0)
    partials = torch.empty((b, chunks, 2), dtype=torch.float32,
                           device=x.device)
    rc = kernels.library().gn1_gelu_fwd_stream(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        stats.data_ptr(), partials.data_ptr(), b, c, hw, float(eps), act,
        int(x.dtype == torch.bfloat16), STREAM_CHUNK,
        chunks, vec, kernels.stream_ptr(x.device))
    kernels.check(rc, "gn1_gelu_fwd_stream")
    kernels.launches["gn1_gelu_fwd_stream"] += 1
    kernels.act_launches["gn1_gelu_fwd_stream", act] += 1


# ---- the backward's plan (csrc/gn1_gelu.cu: gn1_bwd_ticket) --------------------
# x + dy bytes an item of whole planes aims at; planes of at most
# BWD_WARP_PLANE elements take a warp each (else the whole CTA); at most
# BWD_MAX_PER planes an item (the kernel's kMaxPer); BWD_WARPS warps a CTA
BWD_ITEM_BYTES = 64 * 1024
BWD_WARP_PLANE = 2048
BWD_MAX_PER = 32
BWD_WARPS = 8

BwdPlan = collections.namedtuple(
    "BwdPlan", "per items grid warp hint counters")
BwdPlan.__doc__ = """gn1_bwd_ticket's plan: ``per`` planes an item, ``items``
items a sample, ``grid`` CTAs (one a ticket: 2 b items), ``warp`` (a warp
per plane), ``hint`` (the loads' L2 policies, where a sample's x and dy
fit L2) and ``counters`` (the int workspace: the ticket, samples whose
coef is published, then per sample its sums items done and its coef's
state)."""


def gn_bwd_plan(b, c, hw, itemsize, resident, l2_bytes):
    """The backward kernel's plan for x [b, c, hw] of ``itemsize`` bytes an
    element on a card with ``resident`` CTAs of the kernel at once and
    ``l2_bytes`` of L2 (see the note at the head of the backward section of
    ``csrc/gn1_gelu.cu``):

    - an item holds ``per`` whole planes, about BWD_ITEM_BYTES of x and dy;
      planes of up to BWD_WARP_PLANE elements go a warp each, and then an
      item holds a multiple of BWD_WARPS planes where the batch has enough
      (so that every resident CTA still gets one);
    - ``hint`` where a sample's x and dy fit L2;
    - ``grid``: one CTA a ticket."""
    plane = 2 * hw * itemsize
    warp = hw <= BWD_WARP_PLANE
    per = max(1, min(BWD_MAX_PER, c, BWD_ITEM_BYTES // plane))
    if warp:
        per = min(per, max(BWD_WARPS, b * c // resident))
        if per >= BWD_WARPS:
            per -= per % BWD_WARPS
    items = -(-c // per)
    return BwdPlan(per=per, items=items, grid=2 * b * items, warp=int(warp),
                   hint=int(c * plane <= l2_bytes), counters=2 + 2 * b)


def gn_bwd_tickets(plan, b):
    """(apply, sample, item) of every ticket of ``plan`` in order, the item
    counted in the sums' order (planes ``gn_bwd_planes``): sample 0's sums
    items, then for each sample s the sums of sample s + 1 (where there is
    one) and s's apply items in the reverse order. The kernel decodes a
    ticket the same way (``decode_ticket``)."""
    k = plan.items
    out = [(0, 0, i) for i in range(k)]
    for s in range(b):
        if s + 1 < b:
            out += [(0, s + 1, i) for i in range(k)]
        out += [(1, s, i) for i in reversed(range(k))]
    return out


def gn_bwd_planes(plan, c, item):
    """The planes [first, end) of a sample that ``item`` covers."""
    return item * plan.per, min(c, (item + 1) * plan.per)


_BWD_RESIDENT = {}


def _bwd_resident(device, bf16, vec):
    """(resident CTAs of the backward kernel, L2 bytes) on ``device``."""
    key = (device, bf16, vec)
    if key not in _BWD_RESIDENT:
        out = (ctypes.c_int * 2)()
        with torch.cuda.device(device):
            kernels.check(kernels.library().gn1_bwd_resident(
                int(bf16), int(vec), out), "gn1_bwd_resident")
        _BWD_RESIDENT[key] = (out[0], out[1])
    return _BWD_RESIDENT[key]


# a sample of fewer x + dy bytes takes the three-kernel route
# (launch_gn1_bwd_three; measured: the note at the head of the backward
# section of csrc/gn1_gelu.cu)
BWD_THREE_BELOW = 7 << 20


def gn_bwd_route(x):
    """"three" for a sample of x and dy under BWD_THREE_BELOW bytes, else
    "ticket" (gn1_bwd_ticket)."""
    small = 2 * x[0].numel() * x.element_size() < BWD_THREE_BELOW
    return "three" if small else "ticket"


def _aligned16(*ts):
    return int(all(t.data_ptr() % 16 == 0 for t in ts))


def gn1_bwd_plan_for(x, dy):
    """(vec, plan) of the backward at x and dy: the 16-byte path where both
    are 16-byte aligned (dx is fresh), and :func:`gn_bwd_plan` for the
    card's resident CTAs and L2."""
    vec = _aligned16(x, dy)
    bf16 = x.dtype == torch.bfloat16
    resident, l2 = _bwd_resident(x.device, bf16, vec)
    b, c = x.shape[:2]
    return vec, gn_bwd_plan(b, c, x[0, 0].numel(), x.element_size(),
                            resident, l2)


def _check_bwd(x, weight, bias, stats, dy, gelu, approximate):
    """The backward's argument checks (the device last, so that each holds
    on any device); returns the activation code."""
    if (x.dtype not in (torch.float32, torch.bfloat16)
            or dy.dtype != x.dtype):
        raise TypeError(f"gn1_gelu_bwd takes f32 or bf16 x and dy of one "
                        f"type, got {x.dtype} and {dy.dtype}")
    if x.ndim < 3 or dy.shape != x.shape:
        raise ValueError(f"expects x and dy of one [b, C, *sp] shape, got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("gn1_gelu_bwd takes contiguous NCHW tensors")
    act = _act(gelu, approximate)
    b = x.shape[0]
    _check_affine(x, weight, bias)
    if (stats.device != x.device or stats.dtype != torch.float32
            or tuple(stats.shape) != (b, 2) or not stats.is_contiguous()):
        raise ValueError(f"stats must be the forward's f32 [{b}, 2] tensor")
    _check_sample_size(x)
    if x.device.type != "cuda" or dy.device != x.device:
        raise ValueError(f"gn1_gelu_bwd takes CUDA tensors, got {x.device}")
    return act


def gn1_gelu_bwd(x, weight, bias, stats, dy, gelu=True, approximate="none"):
    """Launch the backward kernel: (dx, dweight, dbias) of the fused op at
    ``x`` for the output gradient ``dy``, from the forward's ``stats``.
    CUDA, contiguous; ``x`` and ``dy`` both f32 or both bf16, dx in their
    type, dweight and dbias (and every sum) f32."""
    act = _check_bwd(x, weight, bias, stats, dy, gelu, approximate)
    if gn_bwd_route(x) == "three":
        return launch_gn1_bwd_three(x, weight, bias, stats, dy, act)
    vec, plan = gn1_bwd_plan_for(x, dy)
    return launch_gn1_bwd(x, weight, bias, stats, dy, act, vec, plan)


def launch_gn1_bwd(x, weight, bias, stats, dy, act, vec, plan, ctr=None):
    """One launch of the backward kernel under ``plan`` (checked arguments;
    ``ctr``: None, or an int32 [plan.counters] workspace the caller keeps to
    read the counters the call leaves)."""
    b, c = x.shape[:2]
    dx = torch.empty_like(x)
    dw, db = torch.empty_like(weight), torch.empty_like(bias)
    ws = torch.empty((b, c, 2), dtype=torch.float32, device=x.device)
    coef = torch.empty((b, 2), dtype=torch.float32, device=x.device)
    if ctr is None:
        ctr = torch.empty(plan.counters, dtype=torch.int32, device=x.device)
    rc = kernels.library().gn1_gelu_bwd(
        x.data_ptr(), dy.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        stats.data_ptr(), ws.data_ptr(), coef.data_ptr(), ctr.data_ptr(),
        dx.data_ptr(), dw.data_ptr(), db.data_ptr(), b, c, x[0, 0].numel(),
        act, int(x.dtype == torch.bfloat16), vec, plan.per, plan.items,
        plan.warp, plan.hint, plan.grid, kernels.stream_ptr(x.device))
    kernels.check(rc, "gn1_gelu_bwd")
    kernels.launches["gn1_gelu_bwd"] += 1
    kernels.route_launches["gn1_gelu_bwd", "ticket"] += 1
    return dx, dw, db


def launch_gn1_bwd_three(x, weight, bias, stats, dy, act):
    """The three-kernel route (gn1_bwd_sums, gn1_bwd_reduce, gn1_bwd_apply:
    one CTA a plane), for samples under BWD_THREE_BELOW bytes (checked
    arguments)."""
    b, c = x.shape[:2]
    hw = x[0, 0].numel()
    dx = torch.empty_like(x)
    dw, db = torch.empty_like(weight), torch.empty_like(bias)
    ws = torch.empty((b, c, 2), dtype=torch.float32, device=x.device)
    coef = torch.empty((b, 2), dtype=torch.float32, device=x.device)
    align = 4 * x.element_size()
    load4 = int(hw % 4 == 0 and all(t.data_ptr() % align == 0
                                    for t in (x, dy, dx)))
    rc = kernels.library().gn1_gelu_bwd_three(
        x.data_ptr(), dy.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        stats.data_ptr(), ws.data_ptr(), coef.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), db.data_ptr(), b, c, hw, act,
        int(x.dtype == torch.bfloat16), load4, kernels.stream_ptr(x.device))
    kernels.check(rc, "gn1_gelu_bwd_three")
    kernels.launches["gn1_gelu_bwd"] += 1
    kernels.route_launches["gn1_gelu_bwd", "three"] += 1
    return dx, dw, db


class GNGeluFn(torch.autograd.Function):
    """GroupNorm(1) [+ GELU, exact or tanh] on CUDA tensors: the forward
    kernel, and the backward kernel for its gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, gelu, eps, approximate="none"):
        y, stats = gn1_gelu_fwd_stats(x, weight, bias, gelu, eps,
                                      approximate)
        ctx.save_for_backward(x, weight, bias, stats)
        ctx.gelu = gelu
        ctx.approximate = approximate
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, stats = ctx.saved_tensors
        dx, dw, db = gn1_gelu_bwd(x, weight, bias, stats, dy.contiguous(),
                                  ctx.gelu, ctx.approximate)
        return dx, dw, db, None, None, None


def gn_gelu(x, weight, bias, gelu=True, eps=EPS, approximate="none"):
    """GroupNorm(1 group) [+ GELU, ``approximate`` "none" (erf) or "tanh"].
    Where a gradient is wanted: plain autograd on the CPU, :class:`GNGeluFn`
    on CUDA; otherwise the custom op ``nps_torch::gn1_gelu_fwd`` on either
    device."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, bias)):
        if x.device.type == "cpu":
            return gn_gelu_plain(x, weight, bias, gelu, eps, approximate)
        return GNGeluFn.apply(x, weight, bias, bool(gelu), eps, approximate)
    return torch.ops.nps_torch.gn1_gelu_fwd(x, weight, bias, bool(gelu),
                                            float(eps), approximate)


# ---- split samples (spatial parallelism) -----------------------------------
# A rank holds some rows of every plane of a sample; the statistics are the
# whole sample's. The fused op splits at its sums: this rank's (sum x, sum
# x^2) per sample, a sum over the x group, then the statistics over the
# whole sample's ``count`` = C * rows * W elements and the normalisation of
# the local rows. The backward splits the same way at its per-sample means
# (coef); dgamma and dbeta stay this rank's shares, which the optimizer's
# sum over the world adds up. On CUDA the stages are the streaming forward's
# and the backward's kernels (csrc/gn1_gelu.cu: gn1_split_*), with the sum
# between them.


def gn_split_sums_plain(x):
    """Plain version of the split's first stage: this rank's (sum x, sum
    x^2) of each sample of x [b, C, *sp], f32 [b, 2]."""
    xf = x.float().reshape(x.shape[0], -1)
    return torch.stack([xf.sum(-1), (xf * xf).sum(-1)], -1)


def gn_split_apply_plain(x, sums, count, weight, bias, gelu=True, eps=EPS,
                         approximate="none"):
    """Plain version of the split's second stage: x normalised by the
    statistics of the summed ``sums`` [b, 2] over ``count`` elements, the
    affine and the activation, in f32, rounded once to x's type."""
    _act(gelu, approximate)
    aff = (-1,) + (1,) * (x.ndim - 1)
    mean = (sums[:, 0] / count).reshape(aff)
    var = torch.clamp(sums[:, 1] / count - mean.reshape(-1) ** 2, min=0.0)
    inv = torch.rsqrt(var + eps).reshape(aff)
    ch = (1, -1) + (1,) * (x.ndim - 2)
    y = ((x.float() - mean) * inv * weight.float().reshape(ch)
         + bias.float().reshape(ch))
    if gelu:
        y = F.gelu(y, approximate=approximate)
    return y.to(x.dtype)


def _split_vec(x, *more):
    """The streaming stages' vector path: 16-byte units of the sample on
    16-byte aligned tensors."""
    per = 16 // x.element_size()
    return int(x[0].numel() % per == 0
               and all(t.data_ptr() % 16 == 0 for t in (x, *more)))


def _split_check(x):
    if x.device.type != "cuda":
        raise ValueError(f"the split GN kernels take CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the split GN kernels take f32 or bf16, got "
                        f"{x.dtype}")
    if x.ndim < 3 or not x.is_contiguous():
        raise ValueError("the split GN kernels take a contiguous [b, C, *sp]")
    return _check_sample_size(x)


def gn1_split_sums(x):
    """The first forward stage on CUDA: this rank's sums, f32 [b, 2]."""
    n = _split_check(x)
    b, c = x.shape[:2]
    chunks = -(-n // STREAM_CHUNK)
    sums = torch.empty((b, 2), dtype=torch.float32, device=x.device)
    partials = torch.empty((b, chunks, 2), dtype=torch.float32,
                           device=x.device)
    rc = kernels.library().gn1_split_sums(
        x.data_ptr(), sums.data_ptr(), partials.data_ptr(), b, c,
        x[0, 0].numel(), int(x.dtype == torch.bfloat16), STREAM_CHUNK,
        chunks, _split_vec(x), kernels.stream_ptr(x.device))
    kernels.check(rc, "gn1_split_sums")
    kernels.launches["gn1_split_sums"] += 1
    return sums


def gn1_split_apply(x, sums, count, weight, bias, act, eps=EPS):
    """The second forward stage on CUDA: (y, stats [b, 2] (mean, inv)) from
    the summed ``sums``."""
    n = _split_check(x)
    b, c = x.shape[:2]
    _check_affine(x, weight, bias)
    chunks = -(-n // STREAM_CHUNK)
    y = torch.empty_like(x)
    stats = torch.empty((b, 2), dtype=torch.float32, device=x.device)
    rc = kernels.library().gn1_split_apply(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        sums.data_ptr(), stats.data_ptr(), b, c, x[0, 0].numel(),
        float(count), float(eps), act, int(x.dtype == torch.bfloat16),
        STREAM_CHUNK, chunks, _split_vec(x, y), kernels.stream_ptr(x.device))
    kernels.check(rc, "gn1_split_apply")
    kernels.launches["gn1_split_apply"] += 1
    return y, stats


def gn1_split_bwd_sums(x, dy, weight, bias, stats, count, act):
    """The first backward stage on CUDA: (this rank's coef [b, 2] over the
    whole sample's ``count``, its dweight, its dbias)."""
    _split_check(x)
    b, c = x.shape[:2]
    f32 = dict(dtype=torch.float32, device=x.device)
    ws, coef = torch.empty((b, c, 2), **f32), torch.empty((b, 2), **f32)
    dw, db = torch.empty_like(weight), torch.empty_like(bias)
    rc = kernels.library().gn1_split_bwd_sums(
        x.data_ptr(), dy.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        stats.data_ptr(), ws.data_ptr(), coef.data_ptr(), dw.data_ptr(),
        db.data_ptr(), b, c, x[0, 0].numel(), float(count), act,
        int(x.dtype == torch.bfloat16), _aligned16(x, dy),
        kernels.stream_ptr(x.device))
    kernels.check(rc, "gn1_split_bwd_sums")
    kernels.launches["gn1_split_bwd_sums"] += 1
    return coef, dw, db


def gn1_split_bwd_apply(x, dy, weight, bias, stats, coef, act):
    """The second backward stage on CUDA: dx of this rank's rows from the
    summed ``coef``."""
    _split_check(x)
    b, c = x.shape[:2]
    dx = torch.empty_like(x)
    rc = kernels.library().gn1_split_bwd_apply(
        x.data_ptr(), dy.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        stats.data_ptr(), coef.data_ptr(), dx.data_ptr(), b, c,
        x[0, 0].numel(), act, int(x.dtype == torch.bfloat16),
        _aligned16(x, dy, dx), kernels.stream_ptr(x.device))
    kernels.check(rc, "gn1_split_bwd_apply")
    kernels.launches["gn1_split_bwd_apply"] += 1
    return dx


class GNGeluSplitFn(torch.autograd.Function):
    """:class:`GNGeluFn` on a row-split sample (``axis``: the x group;
    ``count``: the whole sample's elements), with the sums over the x group
    inside its forward and its backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, act, eps, axis, count):
        from nps_tpu_torch.parallel.spatial import sum_

        sums = sum_(gn1_split_sums(x), axis)
        y, stats = gn1_split_apply(x, sums, count, weight, bias, act, eps)
        ctx.save_for_backward(x, weight, bias, stats)
        ctx.act, ctx.axis, ctx.count = act, axis, count
        return y

    @staticmethod
    def backward(ctx, dy):
        from nps_tpu_torch.parallel.spatial import sum_

        x, weight, bias, stats = ctx.saved_tensors
        dy = dy.contiguous()
        coef, dw, db = gn1_split_bwd_sums(x, dy, weight, bias, stats,
                                          ctx.count, ctx.act)
        dx = gn1_split_bwd_apply(x, dy, weight, bias, stats,
                                 sum_(coef, ctx.axis), ctx.act)
        return dx, dw, db, None, None, None, None


def gn_gelu_split(x, weight, bias, gelu=True, eps=EPS, approximate="none",
                  axis=None, rows=None):
    """:func:`gn_gelu` of a row-split x [b, C, local rows, *rest] whose
    samples have ``rows`` rows in all (``axis``: the x group). The CPU
    takes the plain stages around
    :func:`~nps_tpu_torch.parallel.spatial.spatial_sum`; CUDA the split
    kernels, through :class:`GNGeluSplitFn` where a gradient is wanted."""
    from nps_tpu_torch.parallel.spatial import spatial_sum, sum_

    act = _act(gelu, approximate)
    count = x.shape[1] * rows * x[0, 0, 0].numel()
    if x.device.type == "cpu":
        sums = spatial_sum(gn_split_sums_plain(x), axis)
        return gn_split_apply_plain(x, sums, count, weight, bias, gelu, eps,
                                    approximate)
    x = x.contiguous()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, bias)):
        return GNGeluSplitFn.apply(x, weight, bias, act, eps, axis, count)
    sums = sum_(gn1_split_sums(x), axis)
    return gn1_split_apply(x, sums, count, weight, bias, act, eps)[0]


def group_norm_split(x, num_groups, weight, bias, axis, rows, eps=EPS):
    """:func:`group_norm_plain` of a row-split x whose samples have
    ``rows`` rows in all: the groups' sums over the x group
    (:func:`~nps_tpu_torch.parallel.spatial.spatial_sum`). Returns f32."""
    from nps_tpu_torch.parallel.spatial import spatial_sum

    b, c = x.shape[:2]
    g = num_groups
    if c % g:
        raise ValueError(f"{c} channels do not split into {g} groups")
    xg = x.float().reshape(b, g, -1)
    sums = spatial_sum(torch.stack([xg.sum(-1), (xg * xg).sum(-1)], -1),
                       axis)
    count = c // g * rows * x[0, 0, 0].numel()
    mean = sums[..., :1] / count
    inv = torch.rsqrt(torch.clamp(sums[..., 1:] / count - mean * mean,
                                  min=0.0) + eps)
    y = ((xg - mean) * inv).reshape(x.shape)
    aff = (1, c) + (1,) * (x.ndim - 2)
    return y * weight.float().reshape(aff) + bias.float().reshape(aff)
