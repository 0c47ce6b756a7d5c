"""Data parallelism across processes and ZeRO-1 in the port
(``nps_tpu_torch.parallel``), in real worlds of two processes over gloo on
the CPU, held against the port's single-process step on the same global
batch and against ``nps_tpu``'s single-device step.

Sizes: the U-FNO twophase config at 2 blocks x 16 features, 4 modes, a
16x16 grid, time window 5, 21 frames, a global batch of 4 (2 a rank); the
variable-time FNO at 2 blocks x 16 features. The workers are this file run
as a script (``python tests/test_torch_distributed.py --worker SPEC``) or
the port's training CLI, each on one thread; the test process caps
PyTorch at two, since the suite's workers share the machine's cores.

Bars: a two-rank step against the single process that computes the same
two halves (one thread and a rank's shapes each, the per-half gradients
summed in rank order), loss rtol 1e-5 and per tensor max|d| <= 1e-5 of
max(its own max |ref|, 1e-3 of the model's largest gradient); against
the single-process step on the whole batch of 4, the loss at 1e-5 and
the gradients at REL_BATCH = 5e-5, the half-sum's own distance from that
step (f32 sums of one batch of 4 against two of 2: 1.2e-5 to 1.9e-5 on an
AMD EPYC CPU under torch 2.13, below 1e-5 on others); ZeRO-1 against
unsharded data parallelism, parameters max|d| / max|ref| <= 1e-6; against
JAX, the ROADMAP bars (loss rtol 2e-3, gradients 5e-3 per tensor above a
floor of 1e-5 of the largest, as ``test_torch_train.py``).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from argparse import Namespace

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CFG = "nps_tpu/configs/train/cfg_twophase_ufno.py"
PORT_CFG = "nps_tpu_torch/configs/train/cfg_twophase_ufno.py"
V1_CFG = "nps_tpu_torch/configs/train/cfg_var1d_fno.py"
NT, NX, TW, B, WORLD = 21, 16, 5, 4, 2
REL_DP, REL_ZERO, REL_BATCH = 1e-5, 1e-6, 5e-5
REL_LOSS, REL_GRAD = 2e-3, 5e-3
WORKER_TIMEOUT = 300


def _overrides(data, out, extra=()):
    return [f"--base_resolution=[{NT},{NX},{NX}]",
            f"--super_resolution=[{NT},{NX},{NX}]",
            f"--time_window={TW}", f"--batch_size={B}",
            f"--dataset.base_path={data}", "--dataset.c_filter=[0]",
            "--model.hidden_features=16", "--model.hidden_blocks=2",
            "--model.fno_modes=4", "--trainer.lr_step_interval=1",
            "--trainer.unrolling=1", f"--experiment_path={out}",
            "--experiment_name=run", *extra]


def _parse(fn, cfg, argv):
    saved = sys.argv
    try:
        sys.argv = ["prog", *argv]
        return fn(cfg)
    finally:
        sys.argv = saved


def port_trainer(data, out, extra=(), lr=1e-3):
    """The port's trainer as its CLI builds it, on the CPU, with Adam."""
    from nps_tpu_torch import train_cli
    from nps_tpu_torch.configs.parse import parse_args

    args = _parse(parse_args, PORT_CFG, _overrides(data, out, extra))
    trainer = train_cli.get_config_static(args, device="cpu")[4]
    trainer.set_optimizer(dict(object="optim.Adam", lr=lr))
    return trainer


def _tensors(batch):
    return tuple(torch.from_numpy(np.asarray(a)) for a in batch)


def _slice(batch, rank, world=WORLD):
    b = len(batch[0]) // world
    return tuple(a[rank * b:(rank + 1) * b] for a in batch)


def _grads(trainer):
    return {k: p.grad.detach().clone() for k, p in
            trainer.model.named_parameters() if p.grad is not None}


def _params(trainer):
    return {k: p.detach().clone() for k, p in
            trainer.model.named_parameters()}


# ---------------------------------------------------------------- workers
def _worker_steps(spec, rank):
    """The step scenarios of one rank: two steps of plain data parallelism
    (depth 1 with the given starts, then depth 0 with drawn starts), the
    same two with ZeRO-1, two mini-steps of grad_accum=2 with ZeRO-1, and
    a ZeRO-1 run of 3 epochs against 2 epochs and a resume."""
    from nps_tpu_torch.parallel import state_bytes
    from nps_tpu_torch.utils.seed import set_seed

    data, out = spec["data"], spec["out"]
    g = torch.load(spec["inputs"], weights_only=False)
    batches, steps0 = g["batches"], g["steps0"]
    res = {}
    for name, extra in (("dp", []), ("zero1", ["--trainer.zero1=true"])):
        tr = port_trainer(data, out, ["--trainer.data_parallel=true", *extra])
        tr.load_model(spec["weights"])
        tr.ensure_initialized()
        mine = _slice(_tensors(batches[0]), rank)
        loss1, _ = tr.train_step(mine, 0, 0, unrolled=1,
                                 steps0=_slice((steps0,), rank)[0])
        grads1 = _grads(tr)
        loss2, _ = tr.train_step(mine, 0, 1, unrolled=0)
        res[name] = dict(loss=[float(loss1), float(loss2)], grads1=grads1,
                         grads2=_grads(tr), params=_params(tr),
                         state_bytes=state_bytes(tr.optimizer),
                         optimizer=type(tr.optimizer).__name__)

    tr = port_trainer(data, out, ["--trainer.data_parallel=true"])
    tr.load_model(spec["weights"])
    res["eval"] = _evaluation(tr)

    for name, extra in (("accum", ["--trainer.zero1=true"]),
                        ("accum_dp", [])):
        tr = port_trainer(data, out, ["--trainer.data_parallel=true",
                                      "--trainer.grad_accum=2", *extra])
        tr.load_model(spec["weights"])
        tr.ensure_initialized()
        losses, params = [], []
        for i, batch in enumerate(batches):
            loss, _ = tr.train_step(_slice(_tensors(batch), rank), 0, i,
                                    unrolled=0,
                                    steps0=_slice((steps0,), rank)[0])
            losses.append(float(loss))
            params.append(_params(tr))
        res[name] = dict(loss=losses, params=params, grads=_grads(tr))

    # resume: the same save path on both ranks (rank 0 writes)
    runs = {}
    for tag, epochs, resume in (("A", 3, False), ("B", 2, False),
                                ("B", 3, True)):
        set_seed(17)
        tr = port_trainer(data, f"{out}/{tag}",
                          ["--trainer.data_parallel=true",
                           "--trainer.zero1=true", "--trainer.test_interval=99",
                           "--trainer.checkpoint_interval=1",
                           f"--trainer.num_epochs={epochs}",
                           f"--trainer.resume={resume}"])
        train_losses, _, _ = tr.train()
        runs[f"{tag}{int(resume)}"] = dict(losses=train_losses,
                                          start=tr.start_epoch)
    res["resume"] = runs
    torch.save(res, f"{out}/steps_r{rank}.pt")


def _evaluation(trainer):
    """The validation split's evaluation with its data: (loss, metrics,
    frames [2, n, ...], the number of per-element records)."""
    loss, stats, (frames, other) = trainer.test(
        trainer.get_dataloaders()[1], include_data=True)
    return dict(loss=loss, stats=stats, frames=frames, n=len(other))


def _worker(spec_path):
    from nps_tpu_torch.parallel import init_distributed, world

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    init_distributed(spec["rendezvous"], world_size=spec["world"],
                     rank=spec["rank"], device="cpu", timeout=WORKER_TIMEOUT)
    assert world() == (spec["rank"], spec["world"])
    try:
        _worker_steps(spec, spec["rank"])
    finally:
        torch.distributed.destroy_process_group()


# ------------------------------------------------------------ the harness
def _rendezvous(out):
    """A world's rendezvous: a file store in its own directory ``out``, so
    no other world (of this test run or any other process) can join it."""
    path = os.path.join(str(out), "rendezvous")
    if os.path.exists(path):
        os.remove(path)
    return f"file://{path}"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# a CLI world's rank 0 binds its port seconds after _free_port closed it
# (the ranks are fresh processes that import torch); in that window another
# process may take it
BIND_RETRIES = 2


def _bind_failed(results):
    """Whether a rank's output shows rank 0's store failing to bind."""
    return any("eaddrinuse" in out.lower()
               or "address already in use" in out.lower()
               for _, out in results)


def _run_cli_world(commands_for_port, **kwargs):
    """``_run_world`` of ``commands_for_port(port)`` on a free port, started
    again on a fresh port when, and only when, its output shows the
    rendezvous failing to bind, at most ``BIND_RETRIES`` times."""
    for _ in range(BIND_RETRIES + 1):
        results = _run_world(commands_for_port(_free_port()), **kwargs)
        if not _bind_failed(results):
            break
    return results


def _env():
    env = dict(os.environ)
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(key, None)
    return env


def _run_world(commands, timeout=WORKER_TIMEOUT, signal_when=None):
    """Start one process per command, wait for all (each within
    ``timeout``; the others are killed when one fails or hangs) and return
    their (return code, output). ``signal_when`` = (predicate, rank): once
    the predicate holds, SIGTERM that rank."""
    logs = [tempfile.TemporaryFile("w+") for _ in commands]
    procs = [subprocess.Popen(c, cwd=REPO, env=_env(), stdout=log,
                              stderr=subprocess.STDOUT, text=True)
             for c, log in zip(commands, logs)]
    try:
        if signal_when is not None:
            ready, rank = signal_when
            deadline = time.monotonic() + timeout
            while not ready():
                if time.monotonic() > deadline or any(
                        p.poll() is not None for p in procs):
                    break
                time.sleep(0.2)
            procs[rank].send_signal(signal.SIGTERM)
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.returncode not in (None, 0, 143) for p in procs):
                break   # a rank hung or failed: the others are killed
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _assert_ok(results, codes=(0,)):
    for rank, (rc, out) in enumerate(results):
        assert rc in codes, f"rank {rank} exited {rc}:\n{out[-3000:]}"


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    from nps_tpu_torch.data.synthetic import generate

    root = tmp_path_factory.mktemp("dist")
    # 20 simulations: splits of 16/2/2, each divisible by the world of 2
    generate(str(root / "data" / "twophase"), n_sims=20, n_channels=1,
             nt=NT, nx1=NX, nx2=NX, seed=3)
    return root


@pytest.fixture(scope="module")
def reference(data_dir):
    """JAX's trainer and weights, two global batches of the train split
    (JAX's loader, one process), the start steps, and the port's
    single-process runs of every worker scenario from those weights."""
    import jax

    from nps_tpu.configs.parse import parse_args as jax_parse_args
    from nps_tpu.data.pipeline import HostDataLoader as JaxHostDataLoader
    from nps_tpu.train_cli import get_config_static as jax_build

    out = data_dir / "ref"
    jt = jax_build(_parse(jax_parse_args, JAX_CFG,
                          _overrides(data_dir / "data", out)))[5]
    it = iter(JaxHostDataLoader(jt.data.train, B, seed=0, process_index=0,
                                process_count=1))
    batches = [next(it), next(it)]
    with jax.default_matmul_precision("highest"):
        jt.init_params(batches[0])
    params0 = jax.tree_util.tree_map(np.asarray, jt.params)
    steps0 = torch.from_numpy(np.random.default_rng(5).integers(
        TW, NT - 3 * TW + 1, B))

    pt = port_trainer(data_dir / "data", out)
    pt.load_jax_params(params0)
    pt.ensure_initialized()
    weights = {k: v.clone() for k, v in pt.model.state_dict().items()}
    loss1, _ = pt.train_step(_tensors(batches[0]), 0, 0, unrolled=1,
                             steps0=steps0)
    grads1 = _grads(pt)
    loss2, _ = pt.train_step(_tensors(batches[0]), 0, 1, unrolled=0)
    single = dict(dp=dict(loss=[float(loss1), float(loss2)], grads1=grads1,
                          grads2=_grads(pt), params=_params(pt)))
    pt.load_jax_params(params0)
    single["eval"] = _evaluation(pt)
    pt = port_trainer(data_dir / "data", out, ["--trainer.grad_accum=2"])
    pt.load_jax_params(params0)
    pt.ensure_initialized()
    losses, params = [], []
    for i, batch in enumerate(batches):
        loss, _ = pt.train_step(_tensors(batch), 0, i, unrolled=0,
                                steps0=steps0)
        losses.append(float(loss))
        params.append(_params(pt))
    single["accum"] = dict(loss=losses, params=params, grads=_grads(pt))
    pt = port_trainer(data_dir / "data", out)
    pt.load_jax_params(params0)
    pt.ensure_initialized()
    single["halves"] = _halves_steps(pt, _tensors(batches[0]), steps0)
    inputs = data_dir / "inputs.pt"
    torch.save(dict(batches=batches, steps0=steps0), inputs)
    torch.save(weights, data_dir / "weights.pt")
    return dict(jt=jt, params0=params0, batches=batches, steps0=steps0,
                single=single, inputs=inputs, weights=weights)


class _PlusOther(torch.autograd.Function):
    """``global_sum`` of a world of two ranks in one process: forward this
    half's value plus the other half's (the sum gloo forms), backward the
    identity, as ``parallel.mesh._GlobalSum``."""

    @staticmethod
    def forward(ctx, x, other):
        return x + other

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _halves_steps(tr, batch, steps0):
    """The two-rank ``dp`` scenario's two steps (depth 1 at ``steps0``, then
    depth 0 at starts drawn from the shared generator) in one process, on
    one thread as each rank: per step each half of the global batch at a
    rank's shape runs the trainer's own step with this process posing as
    that rank; the loss's global sum is the halves' sums of squares added
    (each half's first computed in a pass without its gradient), each
    half's gradient is kept, their sum in rank order becomes the step's
    gradient, and Adam steps once. Returns {loss, grads1, grads2}."""
    from nps_tpu_torch import parallel

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    saved_sum, inner = parallel.global_sum, tr.optimizer.step
    halves = [_slice(batch, r) for r in range(WORLD)]
    out = dict(loss=[])
    try:
        for i, (unrolled, starts) in enumerate(((1, steps0), (0, None))):
            state = tr.start_rng.get_state()
            kept = {}

            def run(r, other):
                tr.start_rng.set_state(state)
                tr.rank, tr.world, tr.data_parallel = r, WORLD, True
                seen = {}

                def total(sq):
                    seen["sq"] = sq.detach()
                    return sq if other is None else _PlusOther.apply(
                        sq, other)

                parallel.global_sum = total
                tr.optimizer.step = lambda: kept.update({r: _grads(tr)})
                loss, _ = tr.train_step(
                    halves[r], 0, i, unrolled=unrolled,
                    steps0=None if starts is None
                    else _slice((starts,), r)[0])
                return seen["sq"], float(loss)

            sqs = [run(r, None)[0] for r in range(WORLD)]
            losses = [run(r, sqs[1 - r])[1] for r in range(WORLD)]
            assert losses[0] == losses[1]
            out["loss"].append(losses[0])
            with torch.no_grad():
                for k, p in tr.model.named_parameters():
                    p.grad = kept[0][k] + kept[1][k]
            out[f"grads{i + 1}"] = _grads(tr)
            inner()
    finally:
        parallel.global_sum, tr.optimizer.step = saved_sum, inner
        tr.rank, tr.world, tr.data_parallel = 0, 1, False
        torch.set_num_threads(threads)
    return out


@pytest.fixture(scope="module")
def two_ranks(data_dir, reference):
    """Both ranks' results of the step scenarios (``_worker_steps``)."""
    out = data_dir / "world"
    out.mkdir()
    rendezvous = _rendezvous(out)
    commands = []
    for rank in range(WORLD):
        spec = out / f"spec{rank}.json"
        spec.write_text(json.dumps(dict(
            rank=rank, world=WORLD, rendezvous=rendezvous,
            data=str(data_dir / "data"),
            out=str(out), inputs=str(reference["inputs"]),
            weights=str(data_dir / "weights.pt"))))
        commands.append([sys.executable, os.path.abspath(__file__),
                         "--worker", str(spec)])
    _assert_ok(_run_world(commands))
    return [torch.load(out / f"steps_r{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


def _assert_grads_close(got, ref, bar, floor_frac):
    assert set(got) == set(ref)
    floor = floor_frac * max(float(r.abs().max()) for r in ref.values())
    for k, g in got.items():
        scale = max(float(ref[k].abs().max()), floor)
        err = float((g.double() - ref[k].double()).abs().max()) / scale
        assert err <= bar, (k, err)


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("n,p", [(16, 2), (17, 2), (23, 4), (8, 1)])
def test_process_slice_matches_jax(n, p):
    from nps_tpu.parallel import multihost as jax_multihost
    from nps_tpu_torch.parallel import (process_slice,
                                        shard_indices_for_process)

    idx = np.arange(10, 10 + n)
    for i in range(p):
        assert process_slice(n, i, p) == jax_multihost.process_slice(n, i, p)
        np.testing.assert_array_equal(
            shard_indices_for_process(idx, i, p),
            jax_multihost.shard_indices_for_process(idx, i, p))


@pytest.mark.parametrize("bs,p,drop_last", [(8, 2, False), (4, 4, False),
                                            (6, 2, True)])
def test_host_and_device_cache_loaders_match_jax(data_dir, bs, p, drop_last):
    """Each rank's HostDataLoader stream equals the JAX package's loader at
    the same process index and count; the DeviceCacheLoader gathers the
    same elements on the device (here the CPU), epoch after epoch."""
    from nps_tpu.data.pipeline import HostDataLoader as JaxHostDataLoader
    from nps_tpu_torch.data.pde2d import PDE2DDataset
    from nps_tpu_torch.data.pipeline import DeviceCacheLoader, HostDataLoader

    ds = PDE2DDataset(base_path=str(data_dir / "data"), experiment="twophase",
                      split_file="split", data_format="memmap",
                      data_file="snapshots", conditioning="conditioning",
                      spatial_conditioning="spatial_conditioning",
                      name="twophase", c_filter=[0]).train
    for i in range(p):
        kw = dict(shuffle=True, seed=7, drop_last=drop_last, process_index=i,
                  process_count=p)
        ours, cache = HostDataLoader(ds, bs, **kw), DeviceCacheLoader(
            ds, bs, device="cpu", **kw)
        ref = JaxHostDataLoader(ds, bs, **kw)
        assert len(ours) == len(cache) == len(ref) > 0
        for _ in range(2):
            got, held, want = list(ours), list(cache), list(ref)
            assert len(got) == len(held) == len(want) == len(ref)
            for bg, bc, bw in zip(got, held, want):
                for a, c, w in zip(bg, bc, bw):
                    np.testing.assert_array_equal(a, w)
                    np.testing.assert_array_equal(c.numpy(), w)


def test_variable_time_loader_matches_jax(tmp_path):
    """Each rank's min-crop and max-pad stream of a shared seeded sampler
    equals the JAX package's at the same process index and count."""
    from nps_tpu.data.pde1d_var_t import PDE1DVarTDataset as JaxDataset
    from nps_tpu.data.pipeline import VariableTimeLoader as JaxLoader
    from nps_tpu.data.samplers import VariableTimeBatchSampler as JaxSampler
    from nps_tpu_torch.data.pde1d_var_t import PDE1DVarTDataset
    from nps_tpu_torch.data.pipeline import VariableTimeLoader
    from nps_tpu_torch.data.samplers import VariableTimeBatchSampler
    from nps_tpu_torch.data.synthetic import generate_var_t

    generate_var_t(str(tmp_path / "sim1d"), n_sims=16, n_channels=2, nx=32,
                   t_min=20, t_max=50, seed=7)
    kw = dict(base_path=str(tmp_path), experiment="sim1d",
              conditioning="conditioning", split_file="split", name="vt")
    ds, jds = PDE1DVarTDataset(**kw), JaxDataset(**kw)
    for mode in ("min", "max"):
        skw = dict(batch_size=4, time_window=TW, max_unrolling=1,
                   with_replacement=mode == "min", seed=3)
        for i in range(WORLD):
            lkw = dict(mode=mode, time_window=TW, seed=5, process_index=i,
                       process_count=WORLD)
            ours = VariableTimeLoader(
                ds.train, VariableTimeBatchSampler(ds.train, **skw), **lkw)
            ref = JaxLoader(jds.train, JaxSampler(jds.train, **skw), **lkw)
            assert len(ours) == len(ref) > 0
            got, want = list(ours), list(ref)
            assert len(got) == len(want) == len(ours)
            for bg, bw in zip(got, want):
                assert len(bg[1]) == 2
                for a, w in zip(bg, bw):
                    np.testing.assert_array_equal(a, np.asarray(w))


@pytest.mark.parametrize("step", [0, 1])
def test_two_rank_step_matches_single_process(reference, two_ranks, step):
    """Loss and every gradient of the two-rank step (the first at the
    injected depth 1 and starts, the second at depth 0 with starts drawn
    from the shared generator), on both ranks, equal those of the single
    process computing the same two halves (REL_DP), and the single-process
    step on the global batch (the loss at REL_DP, the gradients at
    REL_BATCH, within which the half-sum itself lies)."""
    halves, whole = reference["single"]["halves"], reference["single"]["dp"]
    key = f"grads{step + 1}"
    for res in two_ranks:
        got = res["dp"]
        np.testing.assert_allclose(got["loss"][step], halves["loss"][step],
                                   rtol=REL_DP)
        _assert_grads_close(got[key], halves[key], REL_DP, 1e-3)
        np.testing.assert_allclose(got["loss"][step], whole["loss"][step],
                                   rtol=REL_DP)
        _assert_grads_close(got[key], whole[key], REL_BATCH, 1e-3)
    _assert_grads_close(halves[key], whole[key], REL_BATCH, 1e-3)
    assert two_ranks[0]["dp"]["optimizer"] == "AllReduceGrads"


def test_two_rank_step_matches_jax(reference, two_ranks):
    """The two-rank depth-1 step's loss and gradients against jax.grad of
    the JAX loss on the global batch, same weights and starts."""
    import jax
    import jax.numpy as jnp

    from nps_tpu.train.pushforward import window
    from nps_tpu.utils.process_output import process_step
    from nps_tpu_torch.compat.jax_weights import from_jax_params

    jt, batch = reference["jt"], reference["batches"][0]
    _, u, x, cond, _, sc = (jnp.asarray(a) for a in batch)
    pde, mi = jt.data.pde, jt.model.model_interface

    apply = jax.jit(lambda p, d: jt.model.apply(
        p, d, cond=cond, bc=None, pos=x, t_cond=None, spatial_cond=sc))

    def loss_fn(p, data, labels):
        pred, _ = process_step(pde, mi, apply(p, data), labels, None,
                               get_bc=False, process_settings={})
        return jnp.sqrt(jt.criterion(pred, labels))

    params = jax.tree_util.tree_map(jnp.asarray, reference["params0"])
    with jax.default_matmul_precision("highest"):
        steps = jnp.asarray(reference["steps0"].numpy())
        data, labels = window(u, steps, TW, "both")
        pred = apply(params, data)
        labels_prev, steps = labels, steps + TW
        labels = window(u, steps, TW, "labels")
        data, _ = process_step(pde, mi, pred, labels_prev, labels,
                               process_settings={})
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, data,
                                                           labels)
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, grads))
    for res in two_ranks:
        np.testing.assert_allclose(res["dp"]["loss"][0], float(loss),
                                   rtol=REL_LOSS)
        _assert_grads_close(res["dp"]["grads1"], ref, REL_GRAD, 1e-5)


def test_two_rank_evaluation_matches_single_process(reference, two_ranks):
    """Evaluation sums every rank's losses over the global batch: the
    validation loss and every metric equal the single-process evaluation's
    on both ranks, and the frames it returns are the global batch's."""
    ref = reference["single"]["eval"]
    for res in two_ranks:
        got = res["eval"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=REL_DP)
        assert set(got["stats"]) == set(ref["stats"])
        for k, v in ref["stats"].items():
            np.testing.assert_allclose(got["stats"][k], v, rtol=REL_DP,
                                       err_msg=k)
        assert got["frames"].shape == ref["frames"].shape
        assert got["n"] == ref["n"] == ref["frames"].shape[1]
        assert _rel(got["frames"], ref["frames"]) <= REL_DP


def test_zero1_matches_dp_and_halves_the_state(reference, two_ranks):
    """ZeRO-1's two steps give the unsharded run's losses and gradients
    (and so the single process's on the same two halves, at REL_DP, and
    the single-process step's on the global batch, the gradients at
    REL_BATCH), and its parameters within 1e-6; each parameter's state
    lives on one rank, and each rank holds half the state to within one
    parameter's (whole tensors are split)."""
    halves, whole = reference["single"]["halves"], reference["single"]["dp"]
    for res in two_ranks:
        z, d = res["zero1"], res["dp"]
        assert z["optimizer"] == "Zero1"
        np.testing.assert_allclose(z["loss"], d["loss"], rtol=REL_DP)
        np.testing.assert_allclose(z["loss"], halves["loss"], rtol=REL_DP)
        np.testing.assert_allclose(z["loss"], whole["loss"], rtol=REL_DP)
        for step in (1, 2):
            key = f"grads{step}"
            _assert_grads_close(z[key], d[key], REL_DP, 1e-3)
            _assert_grads_close(z[key], halves[key], REL_DP, 1e-3)
            _assert_grads_close(z[key], whole[key], REL_BATCH, 1e-3)
        for k, v in d["params"].items():
            assert _rel(z["params"][k], v) <= REL_ZERO, k
    # Adam's two f32 moments and one f32 step counter a parameter
    largest = max(8 * v.numel() + 4
                  for v in two_ranks[0]["dp"]["params"].values())
    full = two_ranks[0]["dp"]["state_bytes"]
    shares = [res["zero1"]["state_bytes"] for res in two_ranks]
    assert sum(shares) == full
    for share in shares:
        assert abs(share - full / WORLD) <= largest, (shares, largest)


def test_grad_accum_dp_zero1_matches_single_process(reference, two_ranks):
    """grad_accum=2 with data parallelism and ZeRO-1: the first mini-step
    leaves the parameters as they were; at the boundary the mean gradient
    is the single-process grad_accum=2 run's, and the parameters move to
    unsharded data parallelism's at grad_accum=2 (1e-6); the losses agree.
    (Adam's first update is about lr times the gradient's sign, so
    gradients that differ in their last bits near zero move parameters
    apart by up to lr: the parameters are held against the run that sums
    the same gradients in the same order.)"""
    ref = reference["single"]["accum"]
    for res in two_ranks:
        got, dp = res["accum"], res["accum_dp"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=REL_DP)
        np.testing.assert_allclose(dp["loss"], ref["loss"], rtol=REL_DP)
        first, last = got["params"]
        for k, v in first.items():
            assert torch.equal(v, reference["weights"][k]), k
        _assert_grads_close(got["grads"], ref["grads"], REL_DP, 1e-3)
        for k, v in dp["params"][1].items():
            assert _rel(last[k], v) <= REL_ZERO, k
        moved = max(_rel(last[k], first[k]) for k in last)
        assert moved > 1e-4


def test_zero1_resume_continues_the_run(two_ranks):
    """A ZeRO-1 run of 2 epochs, checkpointed (the state gathered, rank 0
    writing) and resumed for a third, gives the uninterrupted 3-epoch run's
    losses on both ranks."""
    for res in two_ranks:
        runs = res["resume"]
        assert runs["B1"]["start"] == 2
        np.testing.assert_allclose(runs["B0"]["losses"],
                                   runs["A0"]["losses"][:2], rtol=1e-6)
        np.testing.assert_allclose(runs["B1"]["losses"],
                                   runs["A0"]["losses"][2:], rtol=1e-5)
    np.testing.assert_allclose(two_ranks[0]["resume"]["A0"]["losses"],
                               two_ranks[1]["resume"]["A0"]["losses"],
                               rtol=0)


def _cli(data, out, rank, port, extra=(), cfg=PORT_CFG, overrides=None):
    argv = overrides if overrides is not None else _overrides(data, out)
    return [sys.executable, "-m", "nps_tpu_torch.train_cli", "-C", cfg,
            "--device", "cpu", *argv, "--trainer.data_parallel=true",
            f"--trainer.distributed=127.0.0.1:{port},{WORLD},{rank}",
            f"--experiment_path={out}/p{rank}", *extra]


def _losses(text, key="Train losses:"):
    line = [ln for ln in text.splitlines() if ln.startswith(key)][-1]
    return json.loads(line.split(":", 1)[1])


def test_cli_two_processes_writer_guard(data_dir, tmp_path):
    """Two CLI processes joined by --trainer.distributed=host:port,2,i
    train together: each prints its process line, both print the same
    epoch, validation and test losses as one process on the global batch
    (1e-5), and only rank 0's directory gets the models, the checkpoint,
    the metrics and the summary."""
    epochs = ["--trainer.num_epochs=2", "--trainer.test_interval=2"]
    one = [sys.executable, "-m", "nps_tpu_torch.train_cli", "-C", PORT_CFG,
           "--device", "cpu", *_overrides(data_dir / "data", tmp_path),
           *epochs, f"--experiment_path={tmp_path}/one"]
    # a world whose port was taken before rank 0 bound it starts again on
    # another (_run_cli_world, at most BIND_RETRIES times)
    results = _run_cli_world(lambda port: [
        *(_cli(data_dir / "data", tmp_path, r, port, epochs)
          for r in range(WORLD)), one])
    _assert_ok(results)
    texts = [out for _, out in results]
    for r, text in enumerate(texts[:WORLD]):
        assert f"Distributed: process {r} of {WORLD}, backend gloo" in text
    for key in ("Train losses:", "Validation losses:"):
        losses = [_losses(t, key) for t in texts]
        assert np.isfinite(losses[0]).all()
        np.testing.assert_allclose(losses[0], losses[1], rtol=0)
        np.testing.assert_allclose(losses[0], losses[2], rtol=REL_DP)
    assert len(_losses(texts[0])) == 2
    tests = [float(_losses(t, "Test loss:")) for t in texts]
    np.testing.assert_allclose(tests[:WORLD], tests[2], rtol=REL_DP)
    p0 = os.listdir(tmp_path / "p0")
    for suffix in ("_default.pt", "_final.pt", "_checkpoint.pt",
                   "_metrics.jsonl"):
        assert any(f.endswith(suffix) for f in p0), (suffix, p0)
    p1 = tmp_path / "p1"
    assert not p1.exists() or not os.listdir(p1)


def test_sigterm_to_one_rank_stops_both(data_dir, tmp_path):
    """SIGTERM to rank 1 alone: at the next batch boundary both ranks agree
    to stop, rank 0 writes the checkpoint, and both exit as preempted
    (143)."""
    metrics = tmp_path / "p0" / "run_metrics.jsonl"
    # restarted on another port if rank 0 could not bind its own
    # (_run_cli_world, at most BIND_RETRIES times)
    results = _run_cli_world(
        lambda port: [
            _cli(data_dir / "data", tmp_path, r, port,
                 ["--trainer.num_epochs=500", "--trainer.test_interval=999"])
            for r in range(WORLD)],
        signal_when=(lambda: metrics.exists()
                     and len(metrics.read_text().splitlines()) >= 1, 1))
    _assert_ok(results, codes=(143,))
    for _, text in results:
        assert "Preempted at epoch" in text
    assert (tmp_path / "p0" / "run_checkpoint.pt").exists()
    assert not (tmp_path / "p1" / "run_checkpoint.pt").exists()


def test_cli_world_restarts_only_on_a_failed_bind():
    """``_run_cli_world`` starts a world again on a fresh port when a rank's
    output shows its store failing to bind, at most ``BIND_RETRIES`` times,
    and never for another failure."""
    ports = []

    def world(text):
        def commands(port):
            ports.append(port)
            return [[sys.executable, "-c",
                     f"print({text!r}); raise SystemExit(1)"]]
        return commands

    results = _run_cli_world(world(
        "DistNetworkError: The server socket has failed to listen on any "
        "local network address. name: EADDRINUSE"))
    assert len(ports) == BIND_RETRIES + 1 and results[0][0] == 1
    ports.clear()
    results = _run_cli_world(world("RuntimeError: a rank failed"))
    assert len(ports) == 1 and results[0][0] == 1


def test_stop_agreement_answers_the_all_reduce(monkeypatch):
    """The stop agreement at a batch boundary is the all-reduce's answer: a
    stop signal handled right after the all-reduce returned (Python runs a
    handler between bytecodes, so one that arrives during the blocking
    collective lands there) stops this rank at the next boundary, with the
    others, and not at this one, where they go on into the next step's
    collectives (the lost ``test_sigterm_to_one_rank_stops_both`` run: rank
    0 in its next ``global_sum``, its peer gone)."""
    from types import SimpleNamespace

    from nps_tpu_torch.train import base as train_base

    rank = SimpleNamespace(data_parallel=True, device="cpu",
                           _preempt_requested=False)

    def all_reduce_(tensors, op=None):   # the world's flags: none raised
        rank._preempt_requested = True   # ... then this rank's signal
        return tensors

    monkeypatch.setattr(train_base.parallel, "all_reduce_", all_reduce_)
    assert train_base.TrainInterface._preempt_fleet_agreed(rank) is False
    monkeypatch.setattr(train_base.parallel, "all_reduce_",
                        lambda tensors, op=None: tensors)
    assert train_base.TrainInterface._preempt_fleet_agreed(rank) is True


def test_two_rank_var_t_epoch(tmp_path):
    """One CLI epoch of cfg_var1d_fno (narrow) in a world of two: the same
    finite train and validation losses on both ranks."""
    from nps_tpu_torch.data.synthetic import generate_var_t

    generate_var_t(str(tmp_path / "data" / "var1d"), n_sims=16,
                   n_channels=2, nx=32, t_min=20, t_max=50, seed=1)
    argv = [f"--dataset.base_path={tmp_path / 'data'}",
            "--model.hidden_features=16", "--model.fno_modes=4",
            "--batch_size=4", "--trainer.num_epochs=1",
            "--trainer.test_interval=1", "--experiment_name=run"]
    # restarted on another port if rank 0 could not bind its own
    # (_run_cli_world, at most BIND_RETRIES times)
    results = _run_cli_world(lambda port: [
        _cli(None, tmp_path, r, port, cfg=V1_CFG, overrides=argv)
        for r in range(WORLD)])
    _assert_ok(results)
    texts = [out for _, out in results]
    losses = [_losses(t) for t in texts]
    assert np.isfinite(losses[0]).all()
    np.testing.assert_allclose(losses[0], losses[1], rtol=0)
    val = [_losses(t, "Validation losses:") for t in texts]
    assert np.isfinite(val[0]).all()
    np.testing.assert_allclose(val[0], val[1], rtol=0)


@pytest.mark.parametrize("key,item", [("spatial_parallel", 3),
                                      ("tensor_parallel", 4),
                                      ("pipeline_parallel", 5),
                                      ("expert_parallel", 6)])
def test_other_regimes_refused_naming_their_item(key, item):
    """Spatial, tensor, pipeline and expert parallelism are ported (items
    3-6: tests/test_torch_spatial.py, test_torch_tensor_parallel.py,
    test_torch_pipeline_parallel.py, test_torch_expert_parallel.py);
    without a process group for its grid each is refused with a
    ``RuntimeError`` that names its item."""
    from nps_tpu_torch.train import base as train_base

    with pytest.raises(RuntimeError, match=f"P9b item {item}"):
        train_base.refuse_unported(Namespace(data_parallel=True, **{key: 2}))
    train_base.refuse_unported(Namespace(data_parallel=True, **{key: 1}))


def test_worlds_refused_without_data_parallel(monkeypatch):
    """A world of two without data_parallel (each process would train its
    own model), zero1 without data_parallel, and a world that a launcher
    announces (WORLD_SIZE) with no process group are refused."""
    from nps_tpu_torch.train import base as train_base

    with pytest.raises(ValueError, match="data_parallel"):
        train_base.refuse_unported(Namespace(zero1=True))
    train_base.refuse_unported(Namespace(zero1=True, data_parallel=True))
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="requires trainer.data_parallel"):
        train_base.refuse_unported(Namespace(data_parallel=False))
    with pytest.raises(RuntimeError, match="init_distributed"):
        train_base.refuse_unported(Namespace(data_parallel=True))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(sys.argv[2])
