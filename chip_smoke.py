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
             (graph replay) beside their summed bound.

Then a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. Exits non-zero, printing no result, without a CUDA device or outside
a checkout of the repo. Longer outputs (ptxas reports) go to ``--out``.
"""

import argparse
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
SPEC_SHAPE = (BATCH, HIDDEN + N_STATIC + N_SPATIAL, NX1, NX2)
REL_TOL_F32 = 1e-5    # kernel vs plain, f32: sums in another order
REL_TOL_BF16 = 1e-2   # bf16 output: one rounding of an 8-bit mantissa
REL_TOL_STEP = 1e-4   # card vs CPU step, the ROADMAP forward bar


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
    from nps_tpu_torch.ops import spectral as sp

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
    b, ci, n1, n2 = SPEC_SHAPE
    co, m1, m2 = HIDDEN, MODES, MODES
    x = torch.randn(SPEC_SHAPE, device=dev, generator=gen)
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

    w_c = torch.complex(torch.cat(ws, 3)[0], torch.cat(ws, 3)[1])

    def rfft_conv():
        xf = torch.fft.rfft2(x)
        blk = torch.cat([xf[:, :, :m1, :m2], xf[:, :, n1 - m1:, :m2]], dim=2)
        mixed = torch.einsum("bikm,iokm->bokm", blk, w_c)
        out_ft = torch.zeros((b, co, n1, n2 // 2 + 1), dtype=mixed.dtype,
                             device=dev)
        out_ft[:, :, :m1, :m2] = mixed[:, :, :m1]
        out_ft[:, :, n1 - m1:, :m2] = mixed[:, :, m1:]
        return torch.fft.irfft2(out_ft, s=(n1, n2))

    err_library = rel_err(rfft_conv(), y_p)
    K = 2 * m1
    flops = (b * ci * (n1 * n2 * m2 * 4 + n1 * K * m2 * 8)   # forward DFT
             + K * m2 * b * ci * co * 8                      # complex mix
             + b * co * (K * n2 * m2 * 8 + n1 * n2 * K * 4))  # inverse DFT
    nbytes = 4 * (x.numel() + packed.numel() + b * co * n1 * n2)
    bound_ms, bound_by = bound(nbytes, flops)
    rec = {"phase": "kernel", "name": "spectral_dft2d_fwd",
           "shape": [SPEC_SHAPE, co, [m1, m2]], "rel_err": err,
           "rel_err_film": err_film, "rel_err_library_vs_plain": err_library,
           "max_abs_err": float((y_k - y_p).abs().max()),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_how": f"x + weights + out f32 once at 3.35 TB/s "
                        f"({nbytes} B); {flops} flop at 67 TFLOP/s"}
    timed(rec, lambda: sp.spectral_dft2d_fwd(x, packed, (m1, m2)), "ms")
    timed(rec, lambda: sp.spectral_conv_2d_plain(x, ws, (m1, m2)),
          "plain_ms")
    timed(rec, rfft_conv, "library_ms")
    rec["bound_share"] = bound_ms / rec["ms"] if rec["ms"] else None
    emit(rec)
    if not (err < REL_TOL_F32 and err_film < REL_TOL_F32):
        raise AssertionError(f"spectral_dft2d_fwd disagrees: {err}, "
                             f"film {err_film}")
    results["spectral_dft2d_fwd"] = rec
    return results


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
    launches = phase_slice(args.seed, card)

    sources = {"gn1_gelu_fwd": ("nps_tpu_torch/csrc/gn1_gelu.cu",
                                "tools/pallas_group_norm_evidence.py:61"),
               "spectral_dft2d_fwd": (
                   "nps_tpu_torch/csrc/spectral_dft2d.cu",
                   "nps_tpu/ops/pallas/spectral_dft.py:144 (git 92d7866^)")}
    line = []
    for name, (src, replaces) in sources.items():
        r = kern[name]
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"],
                     "bound_share": r["bound_share"], "parity": "ok",
                     "timing": "device: CUDA graph of 20 calls, replayed"})
        if "timing_refused" in r:
            line[-1]["timing_refused"] = r["timing_refused"]
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
