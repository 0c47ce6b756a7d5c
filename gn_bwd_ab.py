"""GN+GELU's backward (``nps_tpu_torch.ops.group_norm.gn1_gelu_bwd``) timed
on the card at every input the train steps give it. One JSON line a record.

The inputs are read from a ``chip_smoke.py`` run's ``lines.jsonl``: the
profile phase's ``gn_bwd_by_name.inputs`` (every distinct shape, dtype and
activation of the twophase families' and ns512's train steps) and the
ns512 train step's calls with their counts (``gn_bwd_step.shapes``).

``python gn_bwd_ab.py --inputs LINES --routes``: in this checkout, each
input through both routes of the backward (``gn1_bwd_ticket`` with its L2
hints as planned and flipped, and the three-kernel route), each result held
against the three-kernel route's, timed by CUDA-graph replay beside the
bound.

``python gn_bwd_ab.py --inputs LINES --ab ROOT [ROOT ...]``: the public
call at every input, the ns512 step's calls together, and the split stages,
timed in each checkout ROOT in turn, each in a process of its own that
imports ROOT's package (the kernels of every ROOT built first, at once): an
A/B of two commits on one card, run as parent, change, change, parent. With
``--train FAMILY ...`` it times train steps instead: ROOT's
``chip_smoke.py:family_train`` of each family (one epoch, then steps at
depths 0 and 8, each the median of its timed steps) on a split made anew.

TF32 is off, as in ``chip_smoke.py``.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

PEAK_BYTES = 3.35e12
ACT = {"off": (False, "none"), "erf": (True, "none"), "tanh": (True, "tanh")}
# the split stages' local shapes (48 of 96 rows; 263 of 526 rows)
SPLIT = [((16, 388, 50, 68), "float32", "erf"),
         ((8, 260, 263, 526), "bfloat16", "tanh")]


def read_inputs(path):
    """(every distinct (shape, dtype, act), the ns512 step's (shape, count))
    from a chip_smoke.py lines.jsonl."""
    inputs = step = None
    with open(path) as f:
        for line in f:
            if not line.startswith("{"):
                continue
            rec = json.loads(line)
            if "gn_bwd_by_name" in rec:
                inputs = [(tuple(s), d, a)
                          for s, d, a in rec["gn_bwd_by_name"]["inputs"]]
            if "gn_bwd_step" in rec:
                step = [(tuple(s), k) for s, _, _, k in
                        rec["gn_bwd_step"]["shapes"]]
    if not (inputs and step):
        raise SystemExit(f"{path} holds no gn_bwd_by_name or gn_bwd_step")
    return inputs, step


def graph_ms(fn, calls=20, replays=10, warmup=3):
    """Device ms per call of ``fn``: ``calls`` calls in one CUDA graph,
    replayed ``replays`` times between two CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def few(shape):
    return dict(calls=5, replays=5, warmup=2) if math.prod(shape) > 1e8 \
        else {}


def case(shape, dtype, act, seed=0):
    """x, gamma, beta, dy, the forward's stats and the activation's
    keywords, on the card."""
    import torch

    from nps_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    x = (torch.randn(shape, device="cuda", generator=g) * 1.5 + 0.3).to(dt)
    w = 1.0 + 0.2 * torch.randn(shape[1], device="cuda", generator=g)
    b = 0.1 * torch.randn(shape[1], device="cuda", generator=g)
    dy = torch.randn(shape, device="cuda", generator=g).to(dt)
    gelu, approx = ACT[act]
    _, stats = gn.gn1_gelu_fwd_stats(x, w, b, gelu, gn.EPS, approx)
    return x, w, b, dy, stats, dict(gelu=gelu, approximate=approx)


def bound_ms(shape, itemsize):
    return 3 * itemsize * math.prod(shape) / PEAK_BYTES * 1e3


def rel(a, ref):
    return float((a.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def routes(inputs):
    import torch

    from nps_tpu_torch.ops import group_norm as gn

    for shape, dtype, act in inputs:
        x, w, b, dy, stats, kw = case(shape, dtype, act)
        code = gn._act(kw["gelu"], kw["approximate"])
        vec, plan = gn.gn1_bwd_plan_for(x, dy)
        runs = {
            "ticket": lambda p=plan: gn.launch_gn1_bwd(
                x, w, b, stats, dy, code, vec, p),
            "ticket_hint_flipped": lambda p=plan._replace(
                hint=1 - plan.hint): gn.launch_gn1_bwd(
                x, w, b, stats, dy, code, vec, p),
            "three": lambda: gn.launch_gn1_bwd_three(
                x, w, b, stats, dy, code)}
        ref = runs["three"]()
        rec = {"shape": list(shape), "dtype": dtype, "act": act,
               "sample_bytes": 2 * x[0].numel() * x.element_size(),
               "route": gn.gn_bwd_route(x), "plan": plan._asdict(),
               "bound_ms": bound_ms(shape, x.element_size())}
        for name, fn in runs.items():
            got = fn()
            rec[f"{name}_err"] = max(rel(got[0], ref[0]),
                                     rel(got[1], ref[1]), rel(got[2], ref[2]))
            rec[f"{name}_ms"] = graph_ms(fn, **few(shape))
        print(json.dumps(rec), flush=True)
        del x, dy, ref, got, runs
        torch.cuda.empty_cache()


def time_public(inputs, step):
    """The A/B's one side: gn1_gelu_bwd at every input, the ns512 step's
    calls together, the split stages."""
    import torch

    from nps_tpu_torch.ops import group_norm as gn

    out = {"device": torch.cuda.get_device_name(0), "inputs": {}}
    for shape, dtype, act in inputs:
        x, w, b, dy, stats, kw = case(shape, dtype, act)
        ms = graph_ms(lambda: gn.gn1_gelu_bwd(x, w, b, stats, dy, **kw),
                      **few(shape))
        out["inputs"][f"{dtype} {act} {list(shape)}"] = {
            "ms": ms, "bound_ms": bound_ms(shape, x.element_size())}
        del x, dy
        torch.cuda.empty_cache()
    args, bnd = [], 0.0
    for shape, k in step:
        for _ in range(k):
            x, w, b, dy, stats, kw = case(shape, "bfloat16", "tanh")
            args.append((x, w, b, stats, dy))
            bnd += bound_ms(shape, 2)

    def run():
        for a in args:
            gn.gn1_gelu_bwd(*a, **kw)

    out["ns512_step"] = {"calls": len(args), "bound_ms": bnd,
                         "ms": graph_ms(run, calls=2, replays=3, warmup=1)}
    del args
    torch.cuda.empty_cache()
    for shape, dtype, act in SPLIT:
        x, w, b, dy, stats, kw = case(shape, dtype, act)
        code = gn._act(kw["gelu"], kw["approximate"])
        count = 2 * math.prod(shape[1:])
        coef, _, _ = gn.gn1_split_bwd_sums(x, dy, w, b, stats, count, code)
        out["inputs"][f"split {dtype} {act} {list(shape)}"] = {
            "sums_ms": graph_ms(lambda: gn.gn1_split_bwd_sums(
                x, dy, w, b, stats, count, code)),
            "apply_ms": graph_ms(lambda: gn.gn1_split_bwd_apply(
                x, dy, w, b, stats, coef, code))}
        del x, dy
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def time_train(families):
    """The A/B's one side for train steps: this checkout's chip_smoke.py
    family_train of each family."""
    import tempfile
    from pathlib import Path

    import chip_smoke

    out = {}
    with tempfile.TemporaryDirectory(prefix="gn_bwd_ab_") as tmp:
        chip_smoke.make_split(tmp, 0)
        for fam in families:
            rec, _, failures = chip_smoke.family_train(fam, 0, Path(tmp), tmp)
            out[fam] = {"failures": failures, **{
                d: {k: st[k] for k in ("step_seconds", "ms_per_step",
                                       "peak_mem_gib")}
                for d, st in rec["steps"].items()}}
    print(json.dumps({"train": out}), flush=True)


def ab(roots, lines, train=()):
    """Build every root's kernels at once, then time_public (or with
    ``train`` time_train) in each root in turn, one process each."""
    me = os.path.abspath(__file__)
    builds = {r: subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " from nps_tpu_torch import kernels; kernels.build()", r])
        for r in dict.fromkeys(roots)}
    for r, p in builds.items():
        if p.wait():
            raise RuntimeError(f"the kernels of {r} did not build")
    for i, r in enumerate(roots):
        t0 = time.perf_counter()
        extra = ["--train", *train] if train else []
        run = subprocess.run([sys.executable, me, "--inputs", lines,
                              "--time", "--root", os.path.abspath(r),
                              *extra],
                             cwd=r, capture_output=True, text=True,
                             check=True)
        rec = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": i, "root": r,
                          "seconds": time.perf_counter() - t0, **rec}),
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--inputs", required=True, metavar="LINES")
    ap.add_argument("--routes", action="store_true")
    ap.add_argument("--ab", nargs="+", metavar="ROOT")
    ap.add_argument("--train", nargs="+", metavar="FAMILY", default=())
    ap.add_argument("--time", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--root", default=".", help=argparse.SUPPRESS)
    args = ap.parse_args()
    inputs, step = read_inputs(args.inputs)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("gn_bwd_ab needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.ab:
        ab(args.ab, os.path.abspath(args.inputs), args.train)
    elif args.time and args.train:
        time_train(args.train)
    elif args.time:
        time_public(inputs, step)
    elif args.routes:
        routes(inputs)
    else:
        ap.error("give --routes or --ab")


if __name__ == "__main__":
    main()
