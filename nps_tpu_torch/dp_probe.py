"""Data-parallel training through the CLI against one process: every loss
each run prints.

    python -m nps_tpu_torch.dp_probe --world 4 \\
        [--spatial K | --tensor K | --pipeline K [--micro M] | --expert K] \\
        [--config CFG] [--repeats 1] [--eval-batch N ...] \\
        [--cross-eval N ...] [--out DIR] [CLI overrides]

Generates one synthetic twophase split (``--sims`` simulations of ``--nt``
frames, seed 0), then trains ``--config`` (``cfg_twophase_ufno``; give
``cfg_twophase_moe`` with ``--expert``) on it for two epochs with the
same seed and config: once with ``--world`` processes started by
``torchrun`` (``--trainer.distributed=auto``, data parallelism and ZeRO-1,
one device a rank; skipped with ``--world 1``; with ``--spatial``,
``--tensor``, ``--pipeline`` or ``--expert`` K > 1 that grid regime
instead of ZeRO-1: a (data, axis) grid of world / K data slices of K
ranks, ``--trainer.spatial_parallel``, ``tensor_parallel``,
``pipeline_parallel`` (with ``--micro``: ``pipeline_microbatches``) or
``expert_parallel`` = K), ``--repeats`` times in one
process, and once in one process for each ``--eval-batch`` (evaluation
batch size; training does not read it). ``--cross-eval`` then evaluates
the final weights of the ``--world`` run and of the first one-process run
in one process (``--trainer.eval_only``) at each evaluation batch size
given: the same weights, so what moves is the evaluation's batching
alone. Prints, for every run, the
pre-training validation, the train and validation losses and the test
loss, then one JSON object of them all; each run's output goes to
``DIR/<run>.log``. Evaluation draws nothing at random, so two runs that
differ only in how they batch the evaluation, or in the last bits of
cuDNN's algorithms, show how far the rollout losses move without any
fault. ``--device cpu`` runs the ranks over gloo (with small-model
overrides, a check on the CPU before a run on cards).
"""

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

CFG = "nps_tpu_torch/configs/train/cfg_twophase_ufno.py"
TIMEOUT = 900


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def by_rank(text):
    """The lines of each rank of a ``torchrun --tee 3`` log (prefixed
    ``[defaultN]:``), as {rank: text}; the whole text as rank 0's where
    no line is prefixed."""
    ranks = {}
    for line in text.splitlines():
        m = re.match(r"^\[default(\d+)\]:(.*)$", line)
        if m:
            ranks.setdefault(int(m[1]), []).append(m[2])
    if not ranks:
        return {0: text}
    return {r: "\n".join(lines) for r, lines in sorted(ranks.items())}


def summary(text, header):
    """The `` • key: value`` lines right after ``header`` (the last such
    block), as a dict; None without one."""
    blocks = text.split(f"\n{header}\n")
    if len(blocks) < 2:
        return None
    out = {}
    for line in blocks[-1].splitlines():
        m = re.match(r"^ • (.+?): ([-+0-9.eEinfa]+)$", line)
        if not m:
            break
        out[m[1]] = float(m[2])
    return out


def readings(text):
    """The losses a CLI run prints: the last train / validation loss
    lists, the test loss, and the pre-training validation and the test
    summaries (the unrolled loss and each step's teacher-forced one)."""
    out = {}
    for key in ("Train losses", "Validation losses"):
        lines = re.findall(rf"^{key}: (\[.*?\])$", text, re.M)
        out[key] = json.loads(lines[-1]) if lines else None
    test = re.findall(r"^Test loss: ([-+0-9.eEinfa]+)$", text, re.M)
    out["Test loss"] = float(test[-1]) if test else None
    for split, loss in re.findall(
            r"^\[default/(valid|test)\] loss: ([-+0-9.eEinfa]+)$", text,
            re.M):
        out[f"eval-only {split}"] = float(loss)
    out["pre-train valid"] = summary(text, "Pre-train valid summary:")
    out["test"] = summary(text, "Test summary:")
    return out


def run(name, cmd, out_dir, env=None):
    log = out_dir / f"{name}.log"
    with open(log, "w") as f:
        rc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT,
                            timeout=TIMEOUT,
                            env=dict(os.environ, **(env or {}))).returncode
    ranks = [readings(t) for t in by_rank(log.read_text()).values()]
    rec = {"rc": rc, **ranks[0], "ranks": len(ranks),
           "ranks_alike": all(r == ranks[0] for r in ranks)}
    print(name, json.dumps(rec), flush=True)
    return rec


def regime_flags(args):
    """The CLI flags of the several-process run's regime: the grid axis
    asked for (at most one), else ZeRO-1."""
    asked = [(key, k) for key, k in (
        ("spatial_parallel", args.spatial), ("tensor_parallel", args.tensor),
        ("pipeline_parallel", args.pipeline),
        ("expert_parallel", args.expert)) if k > 1]
    if len(asked) > 1:
        raise SystemExit(f"dp_probe: one grid regime at a time, got {asked}")
    if not asked:
        return ["--trainer.zero1=true"]
    key, k = asked[0]
    flags = [f"--trainer.{key}={k}"]
    if key == "pipeline_parallel" and args.micro:
        flags.append(f"--trainer.pipeline_microbatches={args.micro}")
    return flags


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--spatial", type=int, default=0)
    ap.add_argument("--tensor", type=int, default=0)
    ap.add_argument("--pipeline", type=int, default=0)
    ap.add_argument("--micro", type=int, default=0)
    ap.add_argument("--expert", type=int, default=0)
    ap.add_argument("--config", default=CFG)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--eval-batch", type=int, nargs="*", default=[])
    ap.add_argument("--cross-eval", type=int, nargs="*", default=[])
    ap.add_argument("--sims", type=int, default=80)
    ap.add_argument("--nt", type=int, default=501)
    ap.add_argument("--nx", type=int, nargs=2, default=[96, 64])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="results/dp_probe")
    args, overrides = ap.parse_known_args(argv)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    from nps_tpu_torch.data.synthetic import generate

    runs = {}
    with tempfile.TemporaryDirectory(prefix="dp_probe_") as tmp:
        generate(f"{tmp}/data/twophase", n_sims=args.sims, n_channels=1,
                 nt=args.nt, nx1=args.nx[0], nx2=args.nx[1], seed=0)
        cli = ["-m", "nps_tpu_torch.train_cli", "-C", args.config,
               "--device", args.device, f"--dataset.base_path={tmp}/data",
               "--dataset.c_filter=[0]", "--seed=0",
               "--trainer.num_epochs=2", "--trainer.test_interval=2",
               "--trainer.print_interval=1", "--experiment_name=run",
               *overrides]
        if args.world > 1:
            runs[f"world{args.world}"] = run(f"world{args.world}", [
                sys.executable, "-m", "torch.distributed.run",
                f"--nproc_per_node={args.world}", "--tee=3",
                f"--master_port={_free_port()}", *cli,
                f"--experiment_path={tmp}/w{args.world}",
                "--trainer.distributed=auto", "--trainer.data_parallel=true",
                *regime_flags(args)], out_dir)
        one = {"CUDA_VISIBLE_DEVICES": "0"} if args.device == "cuda" else {}
        for i in range(args.repeats):
            runs[f"one{i}"] = run(f"one{i}", [
                sys.executable, *cli, f"--experiment_path={tmp}/one{i}"],
                out_dir, one)
        for eb in args.eval_batch:
            runs[f"one_eval{eb}"] = run(f"one_eval{eb}", [
                sys.executable, *cli, f"--experiment_path={tmp}/eval{eb}",
                f"--trainer.eval_batch_size={eb}"], out_dir, one)
        trained = [(name, f"{tmp}/{path}/run_final.pt") for name, path in
                   ((f"world{args.world}", f"w{args.world}"),
                    ("one0", "one0")) if name in runs]
        for name, weights in trained:
            for eb in args.cross_eval:
                tag = f"{name}_weights_eval{eb}"
                runs[tag] = run(tag, [
                    sys.executable, *cli, f"--experiment_path={tmp}/{tag}",
                    "--trainer.eval_only=true",
                    f"--trainer.load_model={weights}",
                    f"--trainer.eval_batch_size={eb}"], out_dir, one)
    print(json.dumps(runs))
    return 0 if all(r["rc"] == 0 for r in runs.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
