#!/usr/bin/env python3
"""Drive the PyTorch port (``nps_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out DIR]

Phases, each printing one JSON line; any failure exits non-zero:

1. device  - the card's name and power limit (nvidia-smi);
2. build   - nvcc builds the kernels from nps_tpu_torch/csrc/ (sm_90a);
3. kernels - each kernel against its plain PyTorch version on the same
             inputs at the main path's shapes, TF32 off: error, kernel time,
             plain-version time, one PyTorch library call's time as a
             yardstick, and the least time the card could take (bound);
             for gn1_gelu_fwd also a device copy of its input. All
             times are device time: 20 calls captured in one CUDA graph,
             replayed and timed with CUDA events, so the wrapper's host cost
             is not in them;
4. slice   - the full-width cfg_twophase_ufno model (3 blocks x 192
             features, 10 modes, 96x64 grid, time window 25) built by
             SurrogateEngine.from_config on the card, random weights from
             the seed, serves three 19-bundled-step rollouts of batch 4
             (the rate is their median); checks shape, finiteness, each
             rollout's kernel launch counts, and one step
             against the same step run by the port on the CPU; then records
             the shapes gn1_gelu_fwd sees in one step and times those calls
             (graph replay) beside their summed bound;
5. train   - the same model built by the training CLI's
             get_config_static and trained on the card: a synthetic
             split from the port's generator (20
             simulations of 501 frames on the 96x64 grid, one channel: the
             one cut, --dataset.c_filter=[0]), 2 epochs at the config's
             batch 16 with a 19-bundled-step validation rollout, best-model
             save and a checkpoint; then train steps at injected depths 0
             and 8 timed (median of 5 after a warm-up, host clock around
             synchronised steps) with their launch counts and peak memory;
             one depth-1 step at batch 2 against the same step run by the
             port on the CPU (loss and every gradient); and both kernel ops
             (GNGeluFn, SpectralConv2dFn), output and gradients, at every
             input shape one train step at batch 16 gave them, against
             autograd through their plain versions.

In the kernels phase the spectral conv runs at the serving batch (4) and
the train batch (16), and the backward ops join the forward kernels at the
train batch: the gn1_gelu_bwd kernel and the spectral conv's backward (the
adjoint launch spectral_dft2d_bwd on dy with the forward's saved weight
pack, and the weight-gradient kernel spectral_dw2d), each against autograd
through its plain version; the backward is called on the autograd node its
forward built, and its two launches are also timed and checked apart,
against their plain versions (spectral_dw2d also for the same bits on two
calls). Their "ms" is graph replay of the op itself; the plain and library
backwards run through the autograd engine, which a graph captured apart
from its forward cannot replay, so theirs are eager calls between two CUDA
events.

Then a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. Exits non-zero, printing no result, without a CUDA device or outside
a checkout of the repo. Longer outputs (ptxas reports) go to ``--out``.
"""

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

CFG = "nps_tpu_torch/configs/train/cfg_twophase_ufno.py"
BATCH, TW, NX1, NX2, N_STEPS, ROLLOUTS = 4, 25, 96, 64, 19, 3
HIDDEN, BLOCKS, MODES = 192, 3, 10
N_STATIC, N_SPATIAL = 2, 2
# H100 SXM published peaks (NVIDIA's data sheet): HBM bytes/s and
# f32 flop/s outside the tensor cores (the kernels use none)
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
# GN+GELU flops per element: sum, square-add, subtract, scale, shift, and
# ~3 for GELU around erff (counted as one)
GN_FLOPS_PER_ELEMENT = 8
GN_SHAPES = [(BATCH, 2 * HIDDEN + N_STATIC + N_SPATIAL, 100, 68),
             (BATCH, HIDDEN, 47, 31)]
SPEC_CI = HIDDEN + N_STATIC + N_SPATIAL
REL_TOL_F32 = 1e-5    # kernel vs plain, f32: sums in another order
REL_TOL_BF16 = 1e-2   # bf16 output: one rounding of an 8-bit mantissa
REL_TOL_STEP = 1e-4   # card vs CPU step, the ROADMAP forward bar
REL_TOL_GRAD = 1e-4   # backward kernels vs plain autograd, f32: more terms
REL_TOL_STEP_GRAD = 5e-3  # card vs CPU gradients, the ROADMAP gradient bar
# the train step's largest GroupNorm input at the config's batch 16
GN_BWD_SHAPE = (16, 2 * HIDDEN + N_STATIC + N_SPATIAL, 100, 68)
# GN+GELU backward flops per element: x-hat, the pre-activation, GELU' around
# one exp (~12), the two sums, then the same again and dx in the apply pass
GN_BWD_FLOPS_PER_ELEMENT = 40
TRAIN_BATCH, TRAIN_SIMS, TRAIN_NT, TRAIN_EPOCHS = 16, 20, 501, 2
# the spectral conv's input: serving at batch 4, training at batch 16 (its
# mix runs two 8-sample tiles there); the backward runs only in training
SPEC_SHAPES = [(b, SPEC_CI, NX1, NX2) for b in (BATCH, TRAIN_BATCH)]
TRAIN_DEPTHS, TIMED_STEPS = (0, 8), 5


def emit(obj):
    print(json.dumps(obj), flush=True)


def rel_err(a, ref):
    return float((a.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def graph_ms(fn, calls=20, replays=10, warmup=3):
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between two CUDA events. Returns
    (ms, None), or (None, why) when the capture is refused; there is no
    fallback to timing eager calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
    except RuntimeError as e:
        return None, f"graph capture refused: {e}"[:300]
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls), None


def event_ms(fn, calls=10, warmup=2):
    """Device time per call of ``fn`` from eager calls between two CUDA
    events (for work a separately captured graph cannot replay)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def timed(rec, fn, key):
    """Put ``fn``'s graph-replay time under ``rec[key]`` (None and the
    reason under ``rec["timing_refused"]`` if capture is refused)."""
    ms, why = graph_ms(fn)
    rec[key] = ms
    if why:
        rec.setdefault("timing_refused", {})[key] = why


def gn_bound(shapes, itemsize=4):
    """Least time of gn1_gelu_fwd over ``shapes``: x read once, y written
    once, GN_FLOPS_PER_ELEMENT flops per element."""
    n = sum(math.prod(s) for s in shapes)
    return bound(2 * itemsize * n, GN_FLOPS_PER_ELEMENT * n)


def spectral_flops(b, ci, co, n1, n2, m1, m2):
    """Flops of one truncated-DFT spectral conv, [b, ci] -> [b, co]."""
    k = 2 * m1
    return (b * ci * (n1 * n2 * m2 * 4 + n1 * k * m2 * 8)   # forward DFT
            + k * m2 * b * ci * co * 8                      # complex mix
            + b * co * (k * n2 * m2 * 8 + n1 * n2 * k * 4))  # inverse DFT


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    emit({"phase": "device", "nvidia_smi": line,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return line


def phase_build(out_dir):
    from nps_tpu_torch import kernels

    t0 = time.perf_counter()
    so = kernels.build()
    kernels.library()
    seconds = time.perf_counter() - t0
    logs = sorted(kernels.BUILD_DIR.glob("*.log"))
    with open(out_dir / "ptxas.log", "w") as f:
        for log in logs:
            f.write(f"==> {log.name}\n{log.read_text()}\n")
    emit({"phase": "build", "seconds": round(seconds, 3), "library": so.name,
          "sources": sorted(p.name for p in kernels.CSRC.glob("*.cu"))})


def phase_kernels(gen):
    import torch
    import torch.nn.functional as F

    from nps_tpu_torch.ops import group_norm as gn

    dev = torch.device("cuda")
    results = {}

    # ---- gn1_gelu_fwd (K2) -------------------------------------------------
    for shape in GN_SHAPES:
        c = shape[1]
        x = torch.randn(shape, device=dev, generator=gen) * 1.5 + 0.3
        gamma = 1.0 + 0.2 * torch.randn(c, device=dev, generator=gen)
        beta = 0.1 * torch.randn(c, device=dev, generator=gen)
        y_k = gn.gn1_gelu_fwd(x, gamma, beta)
        y_p = gn.gn_gelu_plain(x, gamma, beta)
        torch.cuda.synchronize()
        err = rel_err(y_k, y_p)
        xb = x.to(torch.bfloat16)
        err_bf16 = rel_err(gn.gn1_gelu_fwd(xb, gamma, beta),
                           gn.gn_gelu_plain(xb, gamma, beta))
        bound_ms, bound_by = gn_bound([shape])
        rec = {"phase": "kernel", "name": "gn1_gelu_fwd", "shape": shape,
               "rel_err": err, "rel_err_bf16": err_bf16,
               "max_abs_err": float((y_k - y_p).abs().max()),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_how": "x read once + y written once, f32, at 3.35 TB/s"}
        timed(rec, lambda: gn.gn1_gelu_fwd(x, gamma, beta), "ms")
        timed(rec, lambda: gn.gn_gelu_plain(x, gamma, beta), "plain_ms")
        timed(rec, lambda: F.gelu(F.group_norm(x, 1, gamma, beta)),
              "library_ms")
        # a yardstick for the bound: a device copy moves the same bytes
        flat, dst = x.view(-1), torch.empty_like(x).view(-1)
        timed(rec, lambda: dst.copy_(flat), "copy_ms")
        rec["bound_share"] = bound_ms / rec["ms"] if rec["ms"] else None
        emit(rec)
        if not (err < REL_TOL_F32 and err_bf16 < REL_TOL_BF16):
            raise AssertionError(f"gn1_gelu_fwd disagrees at {shape}: "
                                 f"f32 {err}, bf16 {err_bf16}")
        results.setdefault("gn1_gelu_fwd", rec)   # the largest shape

    # ---- spectral_dft2d_fwd (K1) --------------------------------------------
    recs = [spectral_fwd_record(gen, shape) for shape in SPEC_SHAPES]
    results["spectral_dft2d_fwd"] = recs[0]   # the serving shape's
    results["gn1_gelu_bwd"] = gn_bwd_record(gen)
    results["spectral_dft2d_bwd"], results["spectral_dw2d"] = (
        spectral_bwd_records(gen))
    return results


def complex_weights(w1, w2):
    """[weights1, weights2] as one complex [ci, co, 2*m1, m2] tensor."""
    import torch

    w = torch.cat([w1, w2], 3)
    return torch.complex(w[0], w[1])


def rfft_conv(x, w_c, modes):
    """The spectral conv as rfft2 + einsum + irfft2, with the weights in
    complex form (:func:`complex_weights`): the library yardstick."""
    import torch

    m1, m2 = modes
    b, _, n1, n2 = x.shape
    co = w_c.shape[1]
    xf = torch.fft.rfft2(x)
    blk = torch.cat([xf[:, :, :m1, :m2], xf[:, :, n1 - m1:, :m2]], dim=2)
    mixed = torch.einsum("bikm,iokm->bokm", blk, w_c)
    out_ft = torch.zeros((b, co, n1, n2 // 2 + 1), dtype=mixed.dtype,
                         device=x.device)
    out_ft[:, :, :m1, :m2] = mixed[:, :, :m1]
    out_ft[:, :, n1 - m1:, :m2] = mixed[:, :, m1:]
    return torch.fft.irfft2(out_ft, s=(n1, n2))


def spectral_fwd_record(gen, shape):
    """spectral_dft2d_fwd at ``shape`` -> HIDDEN channels, with and without
    FiLM, against its plain version; times beside the library call's."""
    import torch

    from nps_tpu_torch.ops import spectral as sp

    dev = torch.device("cuda")
    b, ci, n1, n2 = shape
    co, m1, m2 = HIDDEN, MODES, MODES
    x = torch.randn(shape, device=dev, generator=gen)
    ws = [torch.rand((2, ci, co, m1, m2), device=dev, generator=gen)
          / (ci * co) for _ in range(2)]
    packed = sp.pack_weights_2d(ws)
    y_k = sp.spectral_dft2d_fwd(x, packed, (m1, m2))
    y_p = sp.spectral_conv_2d_plain(x, ws, (m1, m2))
    film = torch.randn((b, co, 2 * m1, m2), device=dev, generator=gen)
    err_film = max(rel_err(sp.spectral_dft2d_fwd(x, packed, (m1, m2), film,
                                                 mode),
                           sp.spectral_conv_2d_plain(x, ws, (m1, m2), film,
                                                     mode))
                   for mode in (0, 1))
    torch.cuda.synchronize()
    err = rel_err(y_k, y_p)
    w_c = complex_weights(*ws)
    err_library = rel_err(rfft_conv(x, w_c, (m1, m2)), y_p)
    flops = spectral_flops(b, ci, co, n1, n2, m1, m2)
    nbytes = 4 * (x.numel() + packed.numel() + b * co * n1 * n2)
    bound_ms, bound_by = bound(nbytes, flops)
    rec = {"phase": "kernel", "name": "spectral_dft2d_fwd",
           "shape": [shape, co, [m1, m2]], "rel_err": err,
           "rel_err_film": err_film, "rel_err_library_vs_plain": err_library,
           "max_abs_err": float((y_k - y_p).abs().max()),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_how": f"x + weights + out f32 once at 3.35 TB/s "
                        f"({nbytes} B); {flops} flop at 67 TFLOP/s"}
    timed(rec, lambda: sp.spectral_dft2d_fwd(x, packed, (m1, m2)), "ms")
    timed(rec, lambda: sp.spectral_conv_2d_plain(x, ws, (m1, m2)),
          "plain_ms")
    timed(rec, lambda: rfft_conv(x, w_c, (m1, m2)), "library_ms")
    rec["bound_share"] = bound_ms / rec["ms"] if rec["ms"] else None
    emit(rec)
    if not (err < REL_TOL_F32 and err_film < REL_TOL_F32):
        raise AssertionError(f"spectral_dft2d_fwd disagrees at {shape}: "
                             f"{err}, film {err_film}")
    return rec


def _grads(fn, leaves, dy):
    """(output, autograd graph inputs, gradients) of ``fn`` at copies of
    ``leaves``; the graph is kept for timing its backward again."""
    import torch

    leaves = [t.detach().clone().requires_grad_() for t in leaves]
    y = fn(*leaves)
    return y, leaves, torch.autograd.grad(y, leaves, dy, retain_graph=True)


def _errors(got, ref):
    return (max(rel_err(a, r) for a, r in zip(got, ref)),
            max(float((a - r).abs().max()) for a, r in zip(got, ref)))


def gn_bwd_record(gen):
    """gn1_gelu_bwd at the train step's largest GroupNorm input against
    autograd through the plain version and through F.group_norm + F.gelu."""
    import torch
    import torch.nn.functional as F

    from nps_tpu_torch.ops import group_norm as gn

    shape, c = GN_BWD_SHAPE, GN_BWD_SHAPE[1]
    x = torch.randn(shape, device="cuda", generator=gen) * 1.5 + 0.3
    gamma = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=gen)
    beta = 0.1 * torch.randn(c, device="cuda", generator=gen)
    dy = torch.randn(shape, device="cuda", generator=gen)
    y_k, stats = gn.gn1_gelu_fwd_stats(x, gamma, beta)
    got = gn.gn1_gelu_bwd(x, gamma, beta, stats, dy)
    y_p, leaves_p, ref = _grads(gn.gn_gelu_plain, (x, gamma, beta), dy)
    torch.cuda.synchronize()
    err, max_abs = _errors(got, ref)
    err_y = rel_err(y_k, y_p)
    n = math.prod(shape)
    bound_ms, bound_by = bound(3 * 4 * n, GN_BWD_FLOPS_PER_ELEMENT * n)
    rec = {"phase": "kernel", "name": "gn1_gelu_bwd", "shape": shape,
           "rel_err": err, "max_abs_err": max_abs, "rel_err_fwd_y": err_y,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_how": "x, dy read once + dx written once, f32, at "
                        "3.35 TB/s"}
    timed(rec, lambda: gn.gn1_gelu_bwd(x, gamma, beta, stats, dy), "ms")
    rec["plain_ms"] = event_ms(lambda: torch.autograd.grad(
        y_p, leaves_p, dy, retain_graph=True))
    del y_p, leaves_p
    y_l, leaves_l, _ = _grads(
        lambda x, w, b: F.gelu(F.group_norm(x, 1, w, b)), (x, gamma, beta),
        dy)
    rec["library_ms"] = event_ms(lambda: torch.autograd.grad(
        y_l, leaves_l, dy, retain_graph=True))
    rec["bound_share"] = bound_ms / rec["ms"] if rec["ms"] else None
    emit(rec)
    if not (err < REL_TOL_GRAD and err_y < REL_TOL_F32):
        raise AssertionError(f"gn1_gelu_bwd disagrees: {err} (forward y "
                             f"{err_y})")
    return rec


def spectral_bwd_records(gen):
    """SpectralConv2dFn's backward (dx and both weight gradients) at the
    train step's shape, called as autograd calls it on the node its forward
    built (so it reads what the forward saved), against autograd through
    the plain version and through rfft2 + einsum + irfft2; then its two
    launches apart, each against its plain version and beside its bound:
    the adjoint launch (spectral_dft2d_bwd) and the weight gradient
    (spectral_dw2d). Returns both records."""
    import torch

    from nps_tpu_torch.ops import spectral as sp

    shape = SPEC_SHAPES[-1]
    b, ci, n1, n2 = shape
    co, m1, m2 = HIDDEN, MODES, MODES
    modes = (m1, m2)
    x = torch.randn(shape, device="cuda", generator=gen)
    ws = [torch.rand((2, ci, co, m1, m2), device="cuda", generator=gen)
          / (ci * co) for _ in range(2)]
    dy = torch.randn((b, co, n1, n2), device="cuda", generator=gen)
    leaves = [t.detach().clone().requires_grad_() for t in (x, *ws)]
    # the output is kept alive with its node: some PyTorch versions free a
    # node's saved tensors with its last output
    y = sp.SpectralConv2dFn.apply(*leaves, modes)
    node = y.grad_fn
    got = node.apply(dy)[:3]
    y_p, leaves_p, ref = _grads(
        lambda x, w1, w2: sp.spectral_conv_2d_plain(x, [w1, w2], modes),
        (x, *ws), dy)
    torch.cuda.synchronize()
    err, max_abs = _errors(got, ref)
    modes_n = 2 * m1 * m2
    w_numel = 2 * ws[0].numel()
    nbytes = 4 * (dy.numel() + w_numel                 # dy, W read
                  + 2 * modes_n * b * ci                # saved spectrum
                  + x.numel() + w_numel)                # dx, dW written
    flops = (spectral_flops(b, co, ci, n1, n2, m1, m2)  # dx: adjoint conv
             + modes_n * b * ci * co * 8)               # dW: complex products
    bound_ms, bound_by = bound(nbytes, flops)
    rec = {"phase": "kernel", "name": "spectral_dft2d_bwd",
           "shape": [shape, co, [m1, m2]], "rel_err": err,
           "max_abs_err": max_abs, "bound_ms": bound_ms,
           "bound_by": bound_by,
           "bound_how": f"dy + weights + saved spectrum read, dx + dW "
                        f"written once, f32, at 3.35 TB/s ({nbytes} B); "
                        f"{flops} flop at 67 TFLOP/s"}
    timed(rec, lambda: node.apply(dy), "ms")
    rec["plain_ms"] = event_ms(lambda: torch.autograd.grad(
        y_p, leaves_p, dy, retain_graph=True))
    del y_p, leaves_p
    y_l, leaves_l, ref_l = _grads(
        lambda x, w1, w2: rfft_conv(x, complex_weights(w1, w2), modes),
        (x, *ws), dy)
    rec["rel_err_library_vs_plain"] = _errors(ref_l, ref)[0]
    rec["library_ms"] = event_ms(lambda: torch.autograd.grad(
        y_l, leaves_l, dy, retain_graph=True))
    del y_l, leaves_l, ref_l
    rec["bound_share"] = bound_ms / rec["ms"] if rec["ms"] else None

    # the adjoint launch on the forward's saved pack
    xr, xi, packed = node.saved_tensors
    adj = sp.spectral_dft2d_bwd(dy, packed, modes)
    adj_err, adj_abs = _errors(adj, sp.spectral_dft2d_bwd_plain(dy, packed,
                                                                modes))
    adj_bytes = 4 * (dy.numel() + packed.numel() + x.numel())
    adj_bound, adj_by = bound(adj_bytes,
                              spectral_flops(b, co, ci, n1, n2, m1, m2))
    rec["adjoint"] = {"rel_err": adj_err, "max_abs_err": adj_abs,
                      "bound_ms": adj_bound, "bound_by": adj_by,
                      "bound_how": f"dy + pack read, dx written once "
                                   f"({adj_bytes} B)"}
    timed(rec["adjoint"], lambda: sp.spectral_dft2d_bwd(dy, packed, modes),
          "ms")
    timed(rec["adjoint"],
          lambda: sp.spectral_dft2d_bwd_plain(dy, packed, modes), "plain_ms")
    rec["adjoint"]["bound_share"] = (adj_bound / rec["adjoint"]["ms"]
                                     if rec["adjoint"]["ms"] else None)
    emit(rec)

    # the weight gradient from the saved spectrum and the adjoint's G
    gr, gi = adj[1:]
    scale = sp.mode_scale(n1, n2, m1, m2, "cuda")
    dw = sp.spectral_dw2d(xr, xi, gr, gi, scale, m1)
    dw_again = sp.spectral_dw2d(xr, xi, gr, gi, scale, m1)
    dw_ref = sp.spectral_weight_grad(xr, xi, gr, gi, scale, m1)
    torch.cuda.synchronize()
    dw_err, dw_abs = _errors(dw, dw_ref)
    dw_bytes = 4 * (2 * modes_n * b * (ci + co) + w_numel)
    dw_bound, dw_by = bound(dw_bytes, modes_n * b * ci * co * 8)
    rec_dw = {"phase": "kernel", "name": "spectral_dw2d",
              "shape": [[modes_n, b, ci], co, [m1, m2]], "rel_err": dw_err,
              "max_abs_err": dw_abs,
              "same_bits": all(torch.equal(a, c)
                               for a, c in zip(dw, dw_again)),
              "bound_ms": dw_bound, "bound_by": dw_by,
              "bound_how": f"X + G read, dW written once, f32, at 3.35 TB/s "
                           f"({dw_bytes} B)",
              "library_ms": None}
    timed(rec_dw, lambda: sp.spectral_dw2d(xr, xi, gr, gi, scale, m1), "ms")
    timed(rec_dw, lambda: sp.spectral_weight_grad(xr, xi, gr, gi, scale, m1),
          "plain_ms")
    rec_dw["bound_share"] = dw_bound / rec_dw["ms"] if rec_dw["ms"] else None
    emit(rec_dw)
    if not (err < REL_TOL_GRAD and adj_err < REL_TOL_F32):
        raise AssertionError(f"spectral_dft2d_bwd disagrees: {err} (adjoint "
                             f"launch {adj_err})")
    if not (dw_err < REL_TOL_F32 and rec_dw["same_bits"]):
        raise AssertionError(f"spectral_dw2d disagrees: {dw_err}, same bits "
                             f"{rec_dw['same_bits']}")
    return rec, rec_dw


def gn_step_time(eng, u0, cond, sc):
    """The gn1_gelu_fwd calls of one bundled step: record the shapes the
    wrapper sees, then time the same calls on fresh inputs (graph replay)
    beside their summed bound."""
    import torch

    from nps_tpu_torch.ops import group_norm as gn

    seen = []
    wrapped = gn.gn1_gelu_fwd

    def record(x, weight, bias, gelu=True, eps=gn.EPS):
        seen.append((tuple(x.shape), x.dtype, gelu))
        return wrapped(x, weight, bias, gelu, eps)

    gn.gn1_gelu_fwd = record
    try:
        eng.step(u0, cond=cond, spatial_cond=sc)
    finally:
        gn.gn1_gelu_fwd = wrapped
    calls = []
    for shape, dtype, gelu in seen:
        x = torch.randn(shape, device="cuda").to(dtype)
        w = torch.ones(shape[1], device="cuda")
        calls.append((x, w, torch.zeros_like(w), gelu))
    ms, why = graph_ms(lambda: [wrapped(*c) for c in calls], calls=5)
    bound_ms, bound_by = gn_bound([s for s, _, _ in seen],
                                  torch.finfo(seen[0][1]).bits // 8)
    counts = {}
    for s, _, _ in seen:
        counts[s] = counts.get(s, 0) + 1
    return {"calls": len(seen),
            "shapes": [[list(s), n] for s, n in sorted(counts.items())],
            "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms if ms else None,
            **({"timing_refused": why} if why else {})}


def phase_slice(seed, card):
    import numpy as np
    import torch

    from nps_tpu_torch import kernels
    from nps_tpu_torch.inference import SurrogateEngine
    from nps_tpu_torch.pde import PDE2D

    pde = PDE2D(tmin=0.0, tmax=10.0, nt=501, L1=1.0, L2=NX2 / NX1, nx1=NX1,
                nx2=NX2, x=None, name="twophase", n_cond_static=N_STATIC,
                n_cond_spatial=N_SPATIAL)
    eng = SurrogateEngine.from_config(CFG, pde=pde, device="cuda")
    eng.init_params(seed=seed)
    rng = np.random.default_rng(seed)
    u0 = (0.1 + 0.8 * rng.random((BATCH, 1, TW, NX1, NX2))).astype(np.float32)
    cond = rng.random((BATCH, N_STATIC)).astype(np.float32)
    sc = (rng.random((BATCH, N_SPATIAL, NX1, NX2)) > 0.9).astype(np.float32)

    step_gpu = eng.step(u0, cond=cond, spatial_cond=sc)   # also warms up
    torch.cuda.reset_peak_memory_stats()
    # ROLLOUTS rollouts, each with the counts set to 0 just before it and
    # read just after it; the rate is their median (the host clock's spread
    # between runs is a few percent)
    seconds, launches = [], []
    for _ in range(ROLLOUTS):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.rollout(u0, N_STEPS, cond=cond, spatial_cond=sc)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches.append(dict(kernels.launches))

    cpu = SurrogateEngine.from_config(CFG, pde=pde, device="cpu")
    cpu.model.load_state_dict({k: v.cpu()
                               for k, v in eng.model.state_dict().items()})
    step_cpu = cpu.step(u0[:1], cond=cond[:1], spatial_cond=sc[:1])
    step_err = float(np.abs(step_gpu[:1] - step_cpu).max()
                     / np.abs(step_cpu).max())

    gn_step = gn_step_time(eng, u0, cond, sc)

    want = {"gn1_gelu_fwd": 48 * N_STEPS, "spectral_dft2d_fwd": 3 * N_STEPS}
    median = sorted(seconds)[len(seconds) // 2]
    rec = {"phase": "slice", "config": CFG, "batch": BATCH,
           "bundled_steps": N_STEPS, "out_shape": list(out.shape),
           "finite": bool(np.isfinite(out).all()),
           "launches": launches[0], "launches_expected": want,
           "step_rel_err_vs_cpu": step_err, "rollout_seconds": seconds,
           "bundled_steps_per_s": N_STEPS / median,
           "samples_steps_per_s": BATCH * N_STEPS / median,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "gn1_gelu_step": gn_step, "card": card, "tf32": False}
    emit(rec)
    if tuple(out.shape) != (BATCH, 1, N_STEPS * TW, NX1, NX2):
        raise AssertionError(f"rollout shape {out.shape}")
    if not rec["finite"]:
        raise AssertionError("rollout has non-finite values")
    if any(n != want for n in launches):
        raise AssertionError(f"launch counts {launches} != {want}")
    if not step_err < REL_TOL_STEP:
        raise AssertionError(f"card vs CPU step differs: {step_err}")
    return launches[0]


def _grad_errors(got, ref):
    """Per parameter max|d| / max|ref|, a tensor whose gradient is below
    1e-5 of the model's largest held at that floor (zero in exact
    arithmetic, f32 noise on both sides); the worst one: (err, name)."""
    floor = 1e-5 * max(float(r.abs().max()) for r in ref.values())
    return max((float((got[k].cpu() - r).abs().max())
                / max(float(r.abs().max()), floor), k)
               for k, r in ref.items())


@contextlib.contextmanager
def kernel_shapes():
    """Record the distinct inputs the kernels' forward calls see inside the
    block: GN+GELU (shape, gelu) and spectral conv (shape, co, modes)."""
    from nps_tpu_torch.ops import group_norm as gn
    from nps_tpu_torch.ops import spectral as sp

    seen = {"gn": set(), "spectral": set()}
    gn_fwd, sp_fwd = gn.gn1_gelu_fwd_stats, sp.spectral_dft2d_fwd_spectrum

    def gn_record(x, weight, bias, gelu=True, eps=gn.EPS):
        seen["gn"].add((tuple(x.shape), bool(gelu)))
        return gn_fwd(x, weight, bias, gelu, eps)

    def sp_record(x, w_packed, modes, film=None, film_mode=1):
        seen["spectral"].add((tuple(x.shape), w_packed.shape[3],
                              tuple(modes)))
        return sp_fwd(x, w_packed, modes, film, film_mode)

    gn.gn1_gelu_fwd_stats = gn_record
    sp.spectral_dft2d_fwd_spectrum = sp_record
    try:
        yield seen
    finally:
        gn.gn1_gelu_fwd_stats, sp.spectral_dft2d_fwd_spectrum = gn_fwd, sp_fwd


def check_shapes(seen, gen):
    """Both kernel ops, output and gradients, at every input ``seen`` in a
    train step, against autograd through their plain versions on fresh
    inputs: output < REL_TOL_F32, each gradient < REL_TOL_GRAD."""
    import torch

    from nps_tpu_torch.ops import group_norm as gn
    from nps_tpu_torch.ops import spectral as sp

    def compare(fn, plain, leaves, dy):
        y, _, got = _grads(fn, leaves, dy)
        y_p, _, ref = _grads(plain, leaves, dy)
        return {"rel_err_y": rel_err(y, y_p),
                "rel_err_grad": _errors(got, ref)[0]}

    rows = []
    for shape, gelu in sorted(seen["gn"]):
        c = shape[1]
        x = torch.randn(shape, device="cuda", generator=gen) * 1.5 + 0.3
        gamma = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=gen)
        beta = 0.1 * torch.randn(c, device="cuda", generator=gen)
        dy = torch.randn(shape, device="cuda", generator=gen)
        rows.append({"op": "GNGeluFn", "shape": shape, "gelu": gelu,
                     **compare(lambda *t: gn.GNGeluFn.apply(*t, gelu, gn.EPS),
                               lambda *t: gn.gn_gelu_plain(*t, gelu),
                               (x, gamma, beta), dy)})
    for shape, co, modes in sorted(seen["spectral"]):
        b, ci, n1, n2 = shape
        x = torch.randn(shape, device="cuda", generator=gen)
        ws = [torch.rand((2, ci, co, *modes), device="cuda", generator=gen)
              / (ci * co) for _ in range(2)]
        dy = torch.randn((b, co, n1, n2), device="cuda", generator=gen)
        rows.append({"op": "SpectralConv2dFn", "shape": shape, "co": co,
                     **compare(lambda x, w1, w2: sp.SpectralConv2dFn.apply(
                                   x, w1, w2, modes),
                               lambda x, w1, w2: sp.spectral_conv_2d_plain(
                                   x, [w1, w2], modes),
                               (x, *ws), dy)})
    torch.cuda.synchronize()
    return rows


def phase_train(seed, card, out_dir):
    """Train the full-width model (built by the CLI's get_config_static)
    for TRAIN_EPOCHS epochs, time single steps at the depths TRAIN_DEPTHS,
    hold one depth-1 step against the CPU, and check both kernel ops at
    every input shape of a step. Returns the 2-epoch run's launches."""
    import tempfile

    import numpy as np
    import torch

    from nps_tpu_torch import kernels, train_cli
    from nps_tpu_torch.configs.parse import parse_args
    from nps_tpu_torch.data.pipeline import prefetch_to_device
    from nps_tpu_torch.data.synthetic import generate
    from nps_tpu_torch.inference import autotuned_convs

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        t0 = time.perf_counter()
        generate(f"{tmp}/data/twophase", n_sims=TRAIN_SIMS, n_channels=1,
                 nt=TRAIN_NT, nx1=NX1, nx2=NX2, seed=seed)
        gen_s = time.perf_counter() - t0
        argv = ["chip_smoke", f"--dataset.base_path={tmp}/data",
                "--dataset.c_filter=[0]", f"--seed={seed}",
                f"--trainer.num_epochs={TRAIN_EPOCHS}",
                "--trainer.test_interval=1", "--trainer.print_interval=1",
                f"--experiment_path={tmp}/out", "--experiment_name=train"]

        def build(device):
            saved = sys.argv
            try:
                sys.argv = argv
                with contextlib.redirect_stdout(sys.stderr):
                    args = parse_args(CFG)
            finally:
                sys.argv = saved
            trainer = train_cli.get_config_static(args, device=device)[4]
            trainer.set_optimizer(dict(args["optimizer"]))
            trainer.set_lr_scheduler(dict(args["lr_scheduler"]))
            return trainer

        trainer = build("cuda")
        if trainer.config.batch_size != TRAIN_BATCH:
            raise AssertionError(f"config batch {trainer.config.batch_size}")
        log = open(out_dir / "train.log", "w")
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            train_losses, val_losses, _ = trainer.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = dict(kernels.launches)
        log.close()
        save = trainer.config.save_path
        with open(save + "_metrics.jsonl") as f:
            metrics = [json.loads(line) for line in f]
        files = {suffix: Path(save + suffix).exists()
                 for suffix in ("_default.pt", "_checkpoint.pt", "_final.pt")}
        n_steps = TRAIN_EPOCHS * len(trainer.get_dataloaders()[0])

        # single steps at injected depths, on one batch of the split
        batches = prefetch_to_device(iter(trainer.get_dataloaders()[0]),
                                     trainer.device)
        batch = next(batches)
        batches.close()
        steps = {}
        with autotuned_convs():
            with kernel_shapes() as seen:   # also a first warm-up
                trainer.train_step(batch, 0, 0, unrolled=1)
            for depth in TRAIN_DEPTHS:
                trainer.train_step(batch, 0, 0, unrolled=depth)  # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                seconds, counts = [], []
                for i in range(TIMED_STEPS):
                    kernels.reset_launches()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    loss, _ = trainer.train_step(batch, 0, i + 1,
                                                 unrolled=depth)
                    torch.cuda.synchronize()
                    seconds.append(time.perf_counter() - t0)
                    counts.append(dict(kernels.launches))
                median = sorted(seconds)[len(seconds) // 2]
                # K1: 3 (depth + 1) forwards, and per backward one adjoint
                # launch on dy and one weight gradient
                want = {"gn1_gelu_fwd": 48 * (depth + 1),
                        "gn1_gelu_bwd": 48,
                        "spectral_dft2d_fwd": 3 * (depth + 1),
                        "spectral_dft2d_bwd": 3, "spectral_dw2d": 3}
                steps[depth] = {
                    "step_seconds": seconds, "ms_per_step": 1e3 * median,
                    "samples_per_s": TRAIN_BATCH / median,
                    "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                    "loss": float(loss), "launches": counts[0],
                    "launches_expected": want,
                    "launches_ok": all(c == want for c in counts)}

            # one depth-1 step at batch 2, card against CPU, same weights
            # and start steps
            cpu = build("cpu")
            cpu.ensure_initialized()  # builds its optimizer
            cpu.model.load_state_dict({k: v.cpu() for k, v in
                                       trainer.model.state_dict().items()})
            small = tuple(t[:2] for t in batch)
            steps0 = torch.randint(TW, TRAIN_NT - 2 * TW + 1, (2,),
                                   generator=torch.Generator().manual_seed(seed))
            loss_gpu, _ = trainer.train_step(small, 0, 0, unrolled=1,
                                             steps0=steps0)
            loss_cpu, _ = cpu.train_step(tuple(t.cpu() for t in small), 0, 0,
                                         unrolled=1, steps0=steps0)
        loss_err = abs(float(loss_gpu) - float(loss_cpu)) / abs(float(loss_cpu))
        grad_err, grad_worst = _grad_errors(
            {k: p.grad for k, p in trainer.model.named_parameters()},
            {k: p.grad for k, p in cpu.model.named_parameters()})
        shape_checks = check_shapes(
            seen, torch.Generator(device="cuda").manual_seed(seed + 1))

    want_run = {"gn1_gelu_bwd": 48 * n_steps,
                "spectral_dft2d_bwd": 3 * n_steps,
                "spectral_dw2d": 3 * n_steps}
    rec = {"phase": "train", "config": CFG, "batch": TRAIN_BATCH,
           "epochs": TRAIN_EPOCHS, "train_steps": n_steps,
           "data": {"sims": TRAIN_SIMS, "nt": TRAIN_NT, "grid": [NX1, NX2],
                    "channels": 1, "cut": "--dataset.c_filter=[0]",
                    "generate_seconds": gen_s},
           "train_seconds": train_s, "train_losses": train_losses,
           "val_losses": val_losses["default"],
           "metrics_lines": len(metrics), "files": files,
           "launches": launches, "launches_expected": want_run,
           "steps": {str(d): v for d, v in steps.items()},
           "step_vs_cpu": {"depth": 1, "batch": 2, "loss_gpu": float(loss_gpu),
                           "loss_cpu": float(loss_cpu),
                           "loss_rel_err": loss_err, "grad_rel_err": grad_err,
                           "worst_grad": grad_worst},
           "kernels_at_train_shapes": shape_checks,
           "card": card, "tf32": False}
    emit(rec)
    if not (np.isfinite(train_losses).all()
            and np.isfinite(val_losses["default"]).all()
            and len(val_losses["default"]) == TRAIN_EPOCHS):
        raise AssertionError("training losses are not finite")
    if len(metrics) != TRAIN_EPOCHS or not all(files.values()):
        raise AssertionError(f"missing outputs: {len(metrics)} metric "
                             f"lines, files {files}")
    if any(launches.get(k) != v for k, v in want_run.items()) or not all(
            launches.get(k) for k in ("gn1_gelu_fwd", "spectral_dft2d_fwd")):
        raise AssertionError(f"training launches {launches}, want {want_run}")
    if not all(v["launches_ok"] for v in steps.values()):
        raise AssertionError("train-step launch counts differ from the "
                             "expected ones")
    bad = [r for r in shape_checks
           if not (r["rel_err_y"] < REL_TOL_F32
                   and r["rel_err_grad"] < REL_TOL_GRAD)]
    if bad or {r["op"] for r in shape_checks} != {"GNGeluFn",
                                                  "SpectralConv2dFn"}:
        raise AssertionError(f"kernels at the train step's shapes: {bad}, "
                             f"{len(shape_checks)} checked")
    if not (loss_err < REL_TOL_STEP and grad_err < REL_TOL_STEP_GRAD):
        raise AssertionError(f"card vs CPU train step: loss {loss_err}, "
                             f"gradient {grad_err} ({grad_worst})")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/chip_smoke")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    import nps_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    card = phase_device()
    phase_build(out_dir)
    kern = phase_kernels(gen)
    serve = phase_slice(args.seed, card)
    train = phase_train(args.seed, card, out_dir)

    # name -> (source, TPU kernel replaced, the path whose run gives
    # "launches"); the forward kernels keep the serving path's count
    sources = {
        "gn1_gelu_fwd": ("nps_tpu_torch/csrc/gn1_gelu.cu",
                         "tools/pallas_group_norm_evidence.py:61", serve),
        "gn1_gelu_bwd": ("nps_tpu_torch/csrc/gn1_gelu.cu",
                         "tools/pallas_group_norm_evidence.py:106 (_gn_bwd, "
                         "XLA)", train),
        "spectral_dft2d_fwd": (
            "nps_tpu_torch/csrc/spectral_dft2d.cu",
            "nps_tpu/ops/pallas/spectral_dft.py:144 (git 92d7866^)", serve),
        "spectral_dft2d_bwd": (
            "nps_tpu_torch/csrc/spectral_dft2d.cu (spectral_dft2d_bwd on dy "
            "with the forward's pack + spectral_dw2d; ms, plain_ms, "
            "library_ms of the whole backward)",
            "nps_tpu/ops/pallas/spectral_dft.py:175 (git 92d7866^, "
            "_pallas_bwd, XLA)", train),
        "spectral_dw2d": (
            "nps_tpu_torch/csrc/spectral_dft2d.cu",
            "nps_tpu/ops/pallas/spectral_dft.py:175 (git 92d7866^, "
            "_pallas_bwd, XLA: its weight gradient)", train)}
    line = []
    for name, (src, replaces, path) in sources.items():
        r = kern[name]
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": path.get(name, 0),
                     "launches_by_path": {"serve": serve.get(name, 0),
                                          "train": train.get(name, 0)},
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"],
                     "bound_share": r["bound_share"], "parity": "ok",
                     "timing": "device: CUDA graph of 20 calls, replayed"
                               + ("; plain and library: eager calls between "
                                  "CUDA events" if name.endswith("_bwd")
                                  else "")})
        for key in ("timing_refused", "same_bits"):
            if key in r:
                line[-1][key] = r[key]
        if "adjoint" in r:   # the backward's adjoint launch alone
            line[-1]["adjoint"] = {k: r["adjoint"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "bound_share")}
    with open(out_dir / "kernels.json", "w") as f:
        json.dump({"card": card, "kernels": line}, f, indent=1)
    emit({"kernels": line})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
