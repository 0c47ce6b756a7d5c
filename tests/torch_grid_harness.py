"""Shared harness of the CPU tests of the port's (data, axis) grids
(``test_torch_tensor_parallel.py``, ``test_torch_pipeline_parallel.py``,
``test_torch_expert_parallel.py``): one regime in real gloo worlds of 2
ranks (K = 2) and of 4 (2 data slices x K = 2), each rank this harness's
worker (``python tests/<file>.py --worker SPEC``, one thread), held
against the port's single-process trainer from the same weights and starts
and against ``nps_tpu``'s single-device step.

Sizes: the twophase config at 2 blocks x 16 features, 4 modes, a 16 x 16
grid, time window 5, 21 frames, a global batch of 4 (the harness of
``test_torch_distributed.py``). Bars: against the port's single process
the forward max|d| / max|ref| and the loss rtol 1e-5, every gradient
(gathered whole) 5e-5 of max(its own max |ref|, 1e-3 of the largest), the
evaluation's loss and every metric rtol 1e-5; against JAX the forward 1e-4,
the loss rtol 2e-3 and the gradients 5e-3 above a floor of 1e-5 of the
largest (the ROADMAP bars).
"""

import json
import os
import sys
from contextlib import contextmanager

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_distributed import (  # noqa: E402
    NT, TW, _assert_grads_close, _assert_ok, _overrides, _parse, _rendezvous,
    _rel, _run_world, _tensors)

B, NX, K = 4, 16, 2
WORKER_TIMEOUT = 300
REL_FWD, REL_LOSS, REL_GRAD = 1e-5, 1e-5, 5e-5
REL_JAX_FWD, REL_JAX_LOSS, REL_JAX_GRAD = 1e-4, 2e-3, 5e-3


def _parse_none(fn, cfg, argv):
    """The config parsed from ``argv``, where a ``--group.key=None`` flag
    sets the key to None (the parsers keep the string)."""
    args = _parse(fn, cfg, argv)
    for flag in argv:
        key, _, value = flag[2:].partition("=")
        if value == "None" and "." in key:
            group, name = key.split(".", 1)
            args[group][name] = None
    return args


def trainer(cfg, data, out, extra=(), lr=1e-3):
    """The port's trainer as its CLI builds it from ``cfg``, on the CPU,
    with Adam."""
    from nps_tpu_torch import train_cli
    from nps_tpu_torch.configs.parse import parse_args

    args = _parse_none(parse_args, cfg, _overrides(data, out, extra))
    tr = train_cli.get_config_static(args, device="cpu")[4]
    tr.set_optimizer(dict(object="optim.Adam", lr=lr))
    return tr


def first_window(tr, batch):
    """The model's apply to the first window of ``batch`` (tensors)."""
    return tr._apply(batch[1][:, :, :TW], batch[3], None, batch[2], None,
                     batch[5])


def jax_reference(data_dir, jax_cfg, extra=()):
    """JAX's trainer from ``jax_cfg`` on the split under ``data_dir``, one
    global batch of B from its loader, its weights (initialised at the
    highest matmul precision), start steps, and JAX's forward of the first
    window and loss and gradients (in the port's names) of a depth-1 step
    from them."""
    import jax
    import jax.numpy as jnp

    from nps_tpu.configs.parse import parse_args as jax_parse_args
    from nps_tpu.data.pipeline import HostDataLoader as JaxHostDataLoader
    from nps_tpu.train.pushforward import window
    from nps_tpu.train_cli import get_config_static as jax_build
    from nps_tpu.utils.process_output import process_step
    from nps_tpu_torch.compat.jax_weights import from_jax_params

    jt = jax_build(_parse_none(jax_parse_args, jax_cfg, _overrides(
        data_dir / "data", data_dir / "ref", extra)))[5]
    batch = next(iter(JaxHostDataLoader(jt.data.train, B, seed=0,
                                        process_index=0, process_count=1)))
    with jax.default_matmul_precision("highest"):
        jt.init_params(batch)
    params0 = jax.tree_util.tree_map(np.asarray, jt.params)
    steps0 = torch.from_numpy(np.random.default_rng(5).integers(
        TW, NT - 3 * TW + 1, B))
    _, u, x, cond, _, sc = (jnp.asarray(a) for a in batch)
    pde, mi = jt.data.pde, jt.model.model_interface
    apply = jax.jit(lambda p, d: jt.model.apply(
        p, d, cond=cond, bc=None, pos=x, t_cond=None, spatial_cond=sc))

    def loss_fn(p, data, labels):
        pred, _ = process_step(pde, mi, apply(p, data), labels, None,
                               get_bc=False, process_settings={})
        return jnp.sqrt(jt.criterion(pred, labels))

    params = jax.tree_util.tree_map(jnp.asarray, params0)
    with jax.default_matmul_precision("highest"):
        forward = np.asarray(apply(params, u[:, :, :TW]))
        steps = jnp.asarray(steps0.numpy())
        data, labels = window(u, steps, TW, "both")
        pred = apply(params, data)
        labels_prev, steps = labels, steps + TW
        labels = window(u, steps, TW, "labels")
        data, _ = process_step(pde, mi, pred, labels_prev, labels,
                               process_settings={})
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, data,
                                                           labels)
    return dict(batch=batch, params0=params0, steps0=steps0,
                forward=forward, loss=float(loss),
                grads=from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                             grads)))


def single_process(data_dir, port_cfg, ref, extra=()):
    """The port's single-process trainer from JAX's weights: its forward of
    the first window, a depth-1 step (loss, gradients) and the evaluation of
    the validation split; writes the weights and the inputs for the
    ranks. It runs on one thread, as each rank does: on the CPU the thread
    count alone moves the depth-1 loss of these weights by about 1e-5."""
    with one_thread():
        return _single_process(data_dir, port_cfg, ref, extra)


@contextmanager
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def _single_process(data_dir, port_cfg, ref, extra):
    pt = trainer(port_cfg, data_dir / "data", data_dir / "ref", extra)
    pt.load_jax_params(ref["params0"])
    pt.ensure_initialized()
    weights = data_dir / "weights.pt"
    torch.save(pt.model.state_dict(), weights)
    t = _tensors(ref["batch"])
    with torch.no_grad():
        forward = first_window(pt, t)
    loss, _ = pt.train_step(t, 0, 0, unrolled=1, steps0=ref["steps0"])
    grads = pt.whole_grads()
    pt.load_model(str(weights))
    ev_loss, stats = pt.test(pt.get_dataloaders()[1])
    inputs = data_dir / "inputs.pt"
    torch.save(dict(batch=ref["batch"], steps0=ref["steps0"]), inputs)
    return dict(forward=forward, loss=float(loss), grads=grads,
                eval=dict(loss=ev_loss, stats=stats), weights=weights,
                inputs=inputs)


# ---------------------------------------------------------------- workers
def grid_trainer(spec, cfg=None, extra=()):
    """The port's trainer on this rank's grid, from the spec's weights."""
    tr = trainer(cfg or spec["cfg"], spec["data"], spec["out"],
                 [*spec["flags"], *extra])
    tr.load_model(spec["weights"])
    tr.ensure_initialized()
    return tr


def mine(tr, batch, steps0):
    """This rank's data slice of the global batch and its start steps."""
    b = len(batch[0]) // tr.world
    part = slice(tr.rank * b, (tr.rank + 1) * b)
    return tuple(t[part] for t in _tensors(batch)), steps0[part]


def sc_forward(spec, g):
    tr = grid_trainer(spec)
    batch, _ = mine(tr, g["batch"], g["steps0"])
    with torch.no_grad():
        return tr.grid.gather_frames(first_window(tr, batch))


def sc_step(spec, g):
    tr = grid_trainer(spec)
    batch, steps0 = mine(tr, g["batch"], g["steps0"])
    loss, _ = tr.train_step(batch, 0, 0, unrolled=1, steps0=steps0)
    return dict(loss=float(loss), grads=tr.whole_grads())


def sc_eval(spec, g):
    tr = grid_trainer(spec)
    loss, stats = tr.test(tr.get_dataloaders()[1])
    return dict(loss=loss, stats=stats)


def sc_save(spec, g):
    """save_model of the loaded weights (rank 0 writes the whole state)."""
    tr = grid_trainer(spec)
    tr.save_model(os.path.join(spec["out"], "saved.pt"))
    return None


def sc_epoch(spec, g):
    """train() for one epoch with its evaluation (the losses), then a
    resume from its checkpoint: the epoch it starts at, and whether its
    parameters and optimizer state are the trained run's, bit for bit."""
    extra = ["--trainer.num_epochs=1", "--trainer.test_interval=1",
             f"--experiment_path={spec['out']}/e"]
    tr = grid_trainer(spec, extra=extra)
    train_losses, val_losses, _ = tr.train()
    again = grid_trainer(spec, extra=[*extra, "--trainer.resume=true"])
    assert again.maybe_resume()

    def leaves(t):
        state = t.optimizer.state_dict()["state"]
        return [*t.model.state_dict().values(),
                *(v for st in state.values() for v in st.values())]

    same = all(torch.equal(a.cpu(), b.cpu())
               for a, b in zip(leaves(tr), leaves(again), strict=True))
    return dict(train=train_losses, val=val_losses,
                resumed_at=again.start_epoch, resumed_same=same)


COMMON = dict(forward=sc_forward, step=sc_step, eval=sc_eval, save=sc_save,
              epoch=sc_epoch)


def worker(spec_path, scenarios):
    """One rank: join the gloo world, run the spec's scenarios (from
    ``scenarios``, name -> fn(spec, inputs)), save the results."""
    from nps_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    init_distributed(spec["rendezvous"], world_size=spec["world"],
                     rank=spec["rank"], device="cpu", timeout=WORKER_TIMEOUT)
    try:
        g = torch.load(spec["inputs"], weights_only=False)
        res = {name: scenarios[name](spec, g) for name in spec["scenarios"]}
        torch.save(res, f"{spec['out']}/r{spec['rank']}.pt")
    finally:
        torch.distributed.destroy_process_group()


def run_world(test_file, data_dir, single, n, cfg, flags, scenarios):
    """Start a world of ``n`` ranks of ``test_file``'s worker; return each
    rank's results (and the world's directory under ``out``)."""
    out = data_dir / f"world{n}"
    out.mkdir()
    rendezvous = _rendezvous(out)
    commands = []
    for rank in range(n):
        spec = out / f"spec{rank}.json"
        spec.write_text(json.dumps(dict(
            rank=rank, world=n, rendezvous=rendezvous, cfg=cfg, flags=flags,
            data=str(data_dir / "data"), out=str(out),
            inputs=str(single["inputs"]), weights=str(single["weights"]),
            scenarios=scenarios)))
        commands.append([sys.executable, os.path.abspath(test_file),
                         "--worker", str(spec)])
    _assert_ok(_run_world(commands, WORKER_TIMEOUT))
    res = [torch.load(out / f"r{r}.pt", weights_only=False)
           for r in range(n)]
    return dict(ranks=res, out=out)


def generate_split(root):
    """The twophase split of the harness: 20 simulations (16/2/2)."""
    from nps_tpu_torch.data.synthetic import generate

    generate(str(root / "data" / "twophase"), n_sims=20, n_channels=1,
             nt=NT, nx1=NX, nx2=NX, seed=3)


# ------------------------------------------------------------------ checks
def check_forward(world, single, jax_ref):
    for res in world["ranks"]:
        got = res["forward"]
        assert got.shape == single["forward"].shape
        assert _rel(got, single["forward"]) <= REL_FWD
        assert _rel(got, jax_ref["forward"]) <= REL_JAX_FWD


def check_step(world, single):
    for res in world["ranks"]:
        got = res["step"]
        np.testing.assert_allclose(got["loss"], single["loss"],
                                   rtol=REL_LOSS)
        _assert_grads_close(got["grads"], single["grads"], REL_GRAD, 1e-3)


def check_step_jax(world, jax_ref):
    for res in world["ranks"]:
        got = res["step"]
        np.testing.assert_allclose(got["loss"], jax_ref["loss"],
                                   rtol=REL_JAX_LOSS)
        _assert_grads_close(got["grads"], jax_ref["grads"], REL_JAX_GRAD,
                            1e-5)


def check_eval(world, single):
    ref = single["eval"]
    for res in world["ranks"]:
        got = res["eval"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=REL_LOSS)
        assert set(got["stats"]) == set(ref["stats"])
        for k, v in ref["stats"].items():
            np.testing.assert_allclose(got["stats"][k], v, rtol=REL_LOSS,
                                       err_msg=k)


def check_saved(world, single):
    """The world's saved model is the whole state dict, bit for bit, and
    loads in one process."""
    saved = torch.load(world["out"] / "saved.pt", weights_only=True)
    want = torch.load(single["weights"], weights_only=True)
    assert list(saved) == list(want)
    for k, v in want.items():
        assert saved[k].shape == v.shape, k
        assert torch.equal(saved[k], v), k


def check_tags(world, single, names):
    """Each named parameter's reduced gradient (one per tag) is the
    single process's: its norm ratio 1, neither K times nor 0."""
    for res in world["ranks"]:
        got = res["step"]["grads"]
        for tag, name in names.items():
            ratio = float(got[name].norm() / single["grads"][name].norm())
            assert abs(ratio - 1) < 1e-3, (tag, name, ratio)


def check_checkpoint_resumes_in_one_process(world, data_dir, cfg):
    """The world's epoch checkpoint (rank 0's file) holds whole tensors:
    the model's, and every per-parameter optimizer tensor but the step
    count shaped as its whole parameter; one process resumes from it and
    holds them bit for bit."""
    out = world["out"]
    tr = trainer(cfg, data_dir / "data", out, [
        "--trainer.num_epochs=1", f"--experiment_path={out}/e",
        "--trainer.resume=true"])
    tr.ensure_initialized()
    assert tr.maybe_resume()
    ckpt = torch.load(tr._ckpt_path(), weights_only=False)
    model = tr.model.state_dict()
    assert list(ckpt["model"]) == list(model)
    for k, v in ckpt["model"].items():
        assert torch.equal(model[k], v), k
    shapes = [p.shape for p in tr.model.parameters()]
    saved = ckpt["optimizer"]["state"]
    loaded = tr.optimizer.state_dict()["state"]
    assert saved and set(saved) == set(loaded)
    for i, entry in saved.items():
        for field, v in entry.items():
            if field != "step":
                assert v.shape == shapes[i], (i, field)
            assert torch.equal(loaded[i][field].cpu(), v), (i, field)
