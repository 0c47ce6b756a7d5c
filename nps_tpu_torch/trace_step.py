"""Where one bundled rollout step, or one train step, of the full-width
U-FNO spends its time.

    python -m nps_tpu_torch.trace_step [--batch 4] [--steps 3] [--tf32]
        [--out results/trace]
    python -m nps_tpu_torch.trace_step --train [--depth 0] [--batch 16]
        [--steps 2] [--tf32] [--out results/trace]

Builds ``cfg_twophase_ufno`` on the GPU as ``chip_smoke.py`` does, warms up
with one step, then traces ``--steps`` steps with ``torch.profiler``. Prints
one JSON line: the host time per step, the device-busy share of the traced
window, the device time of the kernels summed by name (top 25, and every
kernel of the port's CUDA sources), and the median device time of one
spectral-conv call (its three kernels overlap), with the card's name and
power limit. The Chrome trace goes to ``--out``.

With ``--train`` the step is a train step at the injected pushforward
depth ``--depth`` (the trainer built by the training CLI's
``get_config_static`` on a synthetic split of the config's grid, made in a
temporary directory), and the kernel time is also split by the step's
phases: the no-grad pushforward, the forward, the backward and the
optimizer. A kernel belongs to the phase whose profiler range
(``train_step/...``) was open when the CUDA runtime call that launched it
ran; the two are paired by CUPTI's correlation id. What no phase claims is
listed as ``unattributed``: the phases and it sum to the kernel time, and
``unattributed_top`` names the kernels it holds.
"""

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from contextlib import ExitStack, contextmanager, redirect_stdout
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
PORTED_KERNELS = ("gn1_gelu_kernel", "gn1_bwd_", "dft_fwd_kernel",
                  "mix_kernel", "mix_adj_kernel", "dft_inv_kernel",
                  "spectral_dw_kernel")
PHASES = ("pushforward", "forward", "backward", "optimizer")


def _device_events(prof):
    """The device kernels and copies; not the profiler's own records, nor
    the device-side spans of host ranges (``train_step/...``,
    ``Optimizer.step#Adam.step``), which carry their range's name and cover
    kernels counted on their own."""
    events = prof.events()
    host = {e.name for e in events
            if e.device_type == torch.autograd.DeviceType.CPU}
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in PROFILER_RECORDS and e.name not in host]


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


def _is_runtime_call(name):
    """A CUDA API call (``cudaLaunchKernel``, ``cuLaunchKernel``): the
    host side of a launch or a copy."""
    return re.match(r"cu(da)?[A-Z]", name) is not None


def _phases(prof, events, steps):
    """Device ms per step of ``events`` by phase: each event goes to the
    ``train_step/<phase>`` range whose host window holds the runtime call
    that launched it (same correlation id). The backward's calls come from
    autograd's own thread, inside the window of the backward's range, which
    waits for them. The operators' own kernel lists are not used: the
    profiler links kernels to them by ids drawn from two counters, and the
    sums came out above the kernel time."""
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]
    ranges = [(e.time_range.start, e.time_range.end, e.name.split("/", 1)[1])
              for e in cpu if e.name.startswith("train_step/")]
    if not ranges:
        return None
    launched_at = {e.id: e.time_range.start for e in cpu
                   if _is_runtime_call(e.name)}
    out = {p: 0.0 for p in PHASES}
    rest = defaultdict(float)
    for k in events:
        t = launched_at.get(k.id)
        phase = next((p for start, end, p in ranges
                      if t is not None and start <= t <= end), None)
        ms = k.time_range.elapsed_us() / 1e3 / steps
        if phase in out:
            out[phase] += ms
        else:
            rest[k.name[:90]] += ms
    out["unattributed"] = sum(rest.values())
    out["unattributed_top"] = sorted(rest.items(), key=lambda kv: -kv[1])[:5]
    return out


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _rollout_runner(args):
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
    return lambda: eng.rollout(u0, args.steps, cond=cond, spatial_cond=sc)


@contextmanager
def _train_runner(args):
    """A trainer on a synthetic split in a temporary directory; yields the
    traced work: ``--steps`` train steps at depth ``--depth``."""
    from nps_tpu_torch import train_cli
    from nps_tpu_torch.configs.parse import parse_args
    from nps_tpu_torch.data.pipeline import prefetch_to_device
    from nps_tpu_torch.data.synthetic import generate
    from nps_tpu_torch.inference import autotuned_convs

    with tempfile.TemporaryDirectory(prefix="trace_step_") as tmp:
        generate(f"{tmp}/data/twophase", n_sims=args.batch + 4, n_channels=1,
                 nt=501, nx1=96, nx2=64, seed=args.seed)
        saved = sys.argv
        try:
            sys.argv = ["trace_step", f"--dataset.base_path={tmp}/data",
                        "--dataset.c_filter=[0]", f"--seed={args.seed}",
                        f"--batch_size={args.batch}",
                        f"--experiment_path={tmp}/out"]
            with redirect_stdout(sys.stderr):
                cfg = parse_args(CFG)
        finally:
            sys.argv = saved
        trainer = train_cli.get_config_static(cfg, device="cuda")[4]
        trainer.set_optimizer(dict(cfg["optimizer"]))
        trainer.ensure_initialized()
        batches = prefetch_to_device(iter(trainer.get_dataloaders()[0]),
                                     trainer.device)
        batch = next(batches)
        batches.close()

        def run():
            for i in range(args.steps):
                trainer.train_step(batch, 0, i, unrolled=args.depth)

        with autotuned_convs():
            trainer.train_step(batch, 0, 0, unrolled=args.depth)  # warm-up
            yield run


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", action="store_true",
                    help="trace train steps instead of a rollout")
    ap.add_argument("--depth", type=int, default=0,
                    help="pushforward depth of the traced train steps")
    ap.add_argument("--batch", type=int, default=None,
                    help="default: 4 for a rollout, 16 (the config's) to train")
    ap.add_argument("--steps", type=int, default=None,
                    help="default: 3 for a rollout, 2 to train")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tf32", action="store_true")
    ap.add_argument("--out", default="results/trace")
    args = ap.parse_args()
    if args.batch is None:
        args.batch = 16 if args.train else 4
    if args.steps is None:
        args.steps = 2 if args.train else 3

    torch.backends.cuda.matmul.allow_tf32 = args.tf32
    torch.backends.cudnn.allow_tf32 = args.tf32
    card = _card()
    with ExitStack() as stack:
        if args.train:
            run = stack.enter_context(_train_runner(args))
        else:
            run = _rollout_runner(args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    name = f"train_d{args.depth}" if args.train else "rollout"
    prof.export_chrome_trace(str(out / f"{name}_trace.json"))

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

    rec = {
        "card": card, "mode": "train" if args.train else "rollout",
        "batch": args.batch, "steps": args.steps, "tf32": args.tf32,
        "host_ms_per_step": 1e3 * window_s / args.steps,
        "device_ms_per_step": total_dev_us / 1e3 / args.steps,
        "device_busy_share": _busy_share(events, window_s * 1e6),
        "top_kernels": [row(*r) for r in rows[:25]],
        "ported_kernels": [row(*r) for r in rows
                           if any(s in r[1] for s in PORTED_KERNELS)],
        "spectral_dft2d_fwd_call_ms": {
            "median": spans[len(spans) // 2] / 1e3 if spans else None,
            "calls_per_step": len(spans) / args.steps},
    }
    if args.train:
        rec["depth"] = args.depth
        rec["kernel_ms_per_step_by_phase"] = _phases(prof, events,
                                                     args.steps)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
