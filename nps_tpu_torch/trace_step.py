"""Where one bundled rollout step of the full-width U-FNO spends its time.

    python -m nps_tpu_torch.trace_step [--batch 4] [--steps 3] [--tf32]
        [--out results/trace]

Builds ``cfg_twophase_ufno`` on the GPU as ``chip_smoke.py`` does, warms up
with one step, then traces ``--steps`` steps with ``torch.profiler``. Prints
one JSON line: the host time per step, the device-busy share of the traced
window, the device time of the kernels summed by name (top 25, and every
kernel of the port's CUDA sources), and the median device time of one
spectral-conv call (its three kernels overlap), with the card's name and
power limit. The Chrome trace goes to ``--out``.
"""

import argparse
import json
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from nps_tpu_torch.inference import SurrogateEngine
from nps_tpu_torch.pde import PDE2D

CFG = "nps_tpu_torch/configs/train/cfg_twophase_ufno.py"
# device-side records of the profiler's own work, not kernels of the step
PROFILER_RECORDS = ("Buffer Flush", "Activity Buffer Request")
# the device kernels of the port's hand-written CUDA sources, by name
PORTED_KERNELS = ("gn1_gelu_kernel", "dft_fwd_kernel", "mix_kernel",
                  "dft_inv_kernel")


def _device_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in PROFILER_RECORDS]


def _call_spans_us(events, first, last):
    """Device time of each call of a kernel chain: from the start of a
    ``first`` kernel to the end of the next ``last`` kernel (the chain's
    kernels may overlap, so their summed durations overstate it)."""
    spans, start = [], None
    for e in sorted(events, key=lambda e: e.time_range.start):
        if first in e.name:
            start = e.time_range.start
        elif last in e.name and start is not None:
            spans.append(e.time_range.end - start)
            start = None
    return spans


def _busy_share(events, window_us):
    """Share of the window in which at least one device kernel ran."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / window_us if window_us else 0.0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tf32", action="store_true")
    ap.add_argument("--out", default="results/trace")
    args = ap.parse_args()

    torch.backends.cuda.matmul.allow_tf32 = args.tf32
    torch.backends.cudnn.allow_tf32 = args.tf32
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]

    pde = PDE2D(tmin=0.0, tmax=10.0, nt=501, L1=1.0, L2=64 / 96, nx1=96,
                nx2=64, x=None, name="twophase", n_cond_static=2,
                n_cond_spatial=2)
    eng = SurrogateEngine.from_config(CFG, pde=pde, device="cuda")
    eng.init_params(seed=args.seed)
    rng = np.random.default_rng(args.seed)
    b = args.batch
    u0 = (0.1 + 0.8 * rng.random((b, 1, 25, 96, 64))).astype(np.float32)
    cond = rng.random((b, 2)).astype(np.float32)
    sc = (rng.random((b, 2, 96, 64)) > 0.9).astype(np.float32)
    eng.rollout(u0, 1, cond=cond, spatial_cond=sc)          # warm-up
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.rollout(u0, args.steps, cond=cond, spatial_cond=sc)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "rollout_trace.json"))

    events = _device_events(prof)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    rows = sorted(((us, k, n) for k, (us, n) in by_name.items()),
                  reverse=True)
    total_dev_us = sum(r[0] for r in rows)
    spans = sorted(_call_spans_us(events, "dft_fwd_kernel", "dft_inv_kernel"))

    def row(us, k, n):
        return {"name": k[:90], "ms_per_step": us / 1e3 / args.steps,
                "share": us / total_dev_us, "calls_per_step": n / args.steps}

    print(json.dumps({
        "card": card, "batch": b, "steps": args.steps, "tf32": args.tf32,
        "host_ms_per_step": 1e3 * window_s / args.steps,
        "device_ms_per_step": total_dev_us / 1e3 / args.steps,
        "device_busy_share": _busy_share(events, window_s * 1e6),
        "top_kernels": [row(*r) for r in rows[:25]],
        "ported_kernels": [row(*r) for r in rows
                           if any(s in r[1] for s in PORTED_KERNELS)],
        "spectral_dft2d_fwd_call_ms": {
            "median": spans[len(spans) // 2] / 1e3 if spans else None,
            "calls_per_step": len(spans) / args.steps},
    }), flush=True)


if __name__ == "__main__":
    main()
