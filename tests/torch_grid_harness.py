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
largest (the ROADMAP bars). Each file's worlds also run its model cases
(``CASES``, ``case_runs``), held to the same bars.
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


def first_window(tr, t):
    """The model's apply to the first window of the batch tensors ``t`` (its
    labels' window of t_cond; the MP-GNN's graph built first)."""
    tr._ensure_graph_static(t[2], t[1].shape[0])
    return tr._apply(t[1][:, :, :TW], t[3], None, t[2],
                     _t_window(t[4], torch.full((t[1].shape[0],), TW)),
                     t[5])


def _t_window(t, steps):
    """The labels' window of ``t_cond`` [b, c, t] at ``steps``, or None."""
    if t is None or t.numel() == 0:
        return None
    return torch.stack([t[i, :, s:s + TW]
                        for i, s in enumerate(steps.tolist())])


def jax_reference(data_dir, jax_cfg, extra=()):
    """JAX's trainer from ``jax_cfg`` on the split under ``data_dir``, one
    global batch of B from its loader, its weights (initialised at the
    highest matmul precision), start steps, and JAX's forward of the first
    window and loss and gradients (in the port's names) of a depth-1 step
    from them (``case_jax``)."""
    from nps_tpu.configs.parse import parse_args as jax_parse_args
    from nps_tpu.train_cli import get_config_static as jax_build

    jt = jax_build(_parse_none(jax_parse_args, jax_cfg, _overrides(
        data_dir / "data", data_dir / "ref", extra)))[5]
    init = _jax_init(jt)
    return dict(batch=init[1], params0=init[2], steps0=init[3],
                **case_jax(init))


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
    out = _single(pt, data_dir, "", ref["batch"], ref["params0"],
                  ref["steps0"])
    pt.load_model(str(out["weights"]))
    ev_loss, stats = pt.test(pt.get_dataloaders()[1])
    return dict(out, eval=dict(loss=ev_loss, stats=stats))


def _single(tr, root, tag, batch, params0, steps0):
    """The trainer ``tr`` from JAX's weights ``params0``: its forward of the
    first window of ``batch`` and a depth-1 step from ``steps0`` (loss,
    gradients); writes the weights and the inputs for the ranks (their
    names under ``root`` prefixed by ``tag``)."""
    tr.load_jax_params(params0)
    tr.ensure_initialized()
    weights, inputs = root / f"{tag}weights.pt", root / f"{tag}inputs.pt"
    torch.save(tr.model.state_dict(), weights)
    torch.save(dict(batch=batch, steps0=steps0), inputs)
    t = _tensors(batch)
    with torch.no_grad():
        forward = first_window(tr, t)
    loss, _ = tr.train_step(t, 0, 0, unrolled=1, steps0=steps0)
    return dict(forward=forward, loss=float(loss), grads=tr.whole_grads(),
                weights=weights, inputs=inputs)


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


def run_world(test_file, data_dir, single, n, cfg, flags, scenarios,
              cases=()):
    """Start a world of ``n`` ranks of ``test_file``'s worker, each running
    ``scenarios`` (and with "cases" among them the model ``cases``:
    :func:`sc_cases`); return each rank's results (and the world's
    directory under ``out``)."""
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
            scenarios=scenarios, cases=list(cases))))
        commands.append([sys.executable, os.path.abspath(test_file),
                         "--worker", str(spec)])
    _assert_ok(_run_world(commands, WORKER_TIMEOUT))
    res = [torch.load(out / f"r{r}.pt", weights_only=False)
           for r in range(n)]
    return dict(ranks=res, out=out)


def generate_split(root):
    """The twophase split of the harness: 20 simulations (16/2/2), with a
    ``t_conditioning`` memmap beside it (read by the cases with a BC
    encoder)."""
    from nps_tpu_torch.data.synthetic import generate
    from test_torch_conditioning import write_t_conditioning

    generate(str(root / "data" / "twophase"), n_sims=20, n_channels=1,
             nt=NT, nx1=NX, nx2=NX, seed=3)
    write_t_conditioning(root / "data" / "twophase", 20, NT, 5)


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


# ------------------------------------------------------------- model cases
# The models beside each file's own, run as cases inside its worlds (no
# process more): name -> the port's config, the JAX config (the U-FNO's
# where None), the model flags, and entries set in the parsed configs of
# the port ("port") and of JAX ("jax") that no flag reaches. A "d3" case
# is a 3D EncProcDec (its spec) that the trainer of the U-FNO config takes
# through ``model_override``, on a generated 3D batch: no loader or config
# of either package reads 3D data.
BC = dict(object="BCEncoder", bc_encoder_out=4, bc_encoder_hidden=8,
          bc_encoder_kernel=3, bc_encoder_n_hidden=1)
TCOND = {"dataset": {"t_conditioning": "t_conditioning"},
         "model": {"bc_encoder": BC}}
UNET_ATTN = ["--model.hidden_features=16", "--model.ch_mults=[2,1]",
             "--model.is_attn=[True,True]", "--model.mid_attn=true"]
FNO16 = ["--model.hidden_features=16", "--model.hidden_blocks=2",
         "--model.fno_modes=4"]
NX3, N_STATIC3 = (8, 8, 8), 2
D3 = dict(num_c=1, num_spatial_dims=3, time_window=TW, data_structure="grid",
          processor_residual=False, encoder="enc_grid.ElementWise",
          hidden_features=16, hidden_blocks=2,
          decoder="dec_grid.TimeConvDense", dec_delta_mode="per_step",
          activation="gelu")
CASES = {
    # the MP-GNN: every dense layer whose out-features K divides split
    "gnn": dict(cfg="cfg_twophase_gnn.py", flags=[
        "--model.hidden_features=16", "--model.hidden_blocks=2"]),
    # attention at 32 channels: a rank's 48 of the projection's 96 outputs
    # hold q and half of k
    "unet_attn": dict(cfg="cfg_twophase_unet.py", flags=UNET_ATTN),
    # the time-conditioned U-FNO: a BC encoder of 4 outputs over t_cond
    "ufno_tcond": dict(cfg="cfg_twophase_ufno_tcond.py",
                       jax_cfg="cfg_twophase_ufno.py",
                       flags=["--model.hidden_features=8",
                              "--model.hidden_blocks=2",
                              "--model.fno_modes=4"],
                       port_flags=["--model.bc_encoder.bc_encoder_out=4",
                                   "--model.bc_encoder.bc_encoder_hidden=8"],
                       jax=TCOND),
    # the U-FNO with attention on both levels of its mini U-Nets
    "ufno_attn": dict(cfg="cfg_twophase_ufno.py", flags=[
        *FNO16, "--model.is_attn=[True,True]", "--model.mid_attn=true"]),
    # a homogeneous list of two attention U-Nets (JAX's "processor" mode)
    "unet_attn_list": dict(cfg="cfg_twophase_unet.py", flags=UNET_ATTN,
                           both={"model": {
                               "processor": [dict(object="UNetModern"),
                                             dict(object="UNetModern")],
                               "processor_residual": True}}),
    # the MoE with a BC encoder (cfg_twophase_moe ships none)
    "moe_bc": dict(cfg="cfg_twophase_moe.py", flags=FNO16, both=TCOND),
    "fno3d": dict(d3=dict(D3, processor="FNO", fno_modes=2,
                          fno_kernel_size=1, fno_conv_mode="single")),
    "drn3d": dict(d3=dict(D3, processor="DilatedResnet", kernel_size=3,
                          padding_mode="circular", dec_kernel_size=3,
                          dec_padding_mode="circular")),
    "moe3d": dict(d3=dict(D3, processor="MoEFNO", n_experts=2, fno_modes=2,
                          fno_kernel_size=1, fno_conv_mode="single")),
}


def _case_args(name, parse, cfg_root, data, out, extra, side):
    """The case's parsed config (``side`` "port" or "jax"): the side's
    config file, the harness's data and trainer flags, the case's model
    flags (a 3D case's trainer the small U-FNO's) and ``extra``, and the
    entries the case sets."""
    case = CASES[name]
    cfg = case.get("cfg", "cfg_twophase_ufno.py")
    flags = _overrides(data, out, extra)
    if "d3" not in case:
        # the harness's model flags are the U-FNO's: the case's replace them
        flags = [f for f in flags if not f.startswith("--model.")]
        flags += case.get("flags", [])
    if side == "port":
        flags += case.get("port_flags", [])
    else:
        cfg = case.get("jax_cfg", cfg)
    args = _parse_none(parse, f"{cfg_root}/{cfg}", flags)
    for group, entries in {**case.get("both", {}),
                           **case.get(side, {})}.items():
        args[group].update(entries)
    return args


def _pde3d(cls=None):
    """The 3D cases' PDE (the port's ``PDE3D``, or ``cls``)."""
    if cls is None:
        from nps_tpu_torch.pde import PDE3D as cls
    return cls(tmin=0.0, tmax=1.0, nt=NT, L1=1.0, L2=0.8, L3=0.6,
               nx1=NX3[0], nx2=NX3[1], nx3=NX3[2], x=None, name="box3d",
               n_cond_static=N_STATIC3)


def case_trainer(name, data, out, extra=()):
    """The port's trainer of case ``name`` as the CLI builds it, on the CPU,
    with Adam; a 3D case's model through ``model_override``."""
    from nps_tpu_torch import train_cli
    from nps_tpu_torch.configs.parse import parse_args
    from nps_tpu_torch.models.enc_proc_dec import EncProcDec

    case = CASES[name]
    args = _case_args(name, parse_args, "nps_tpu_torch/configs/train",
                      data, out, extra, "port")
    model = (EncProcDec(pde=_pde3d(), **case["d3"]) if "d3" in case
             else None)
    tr = train_cli.get_config_static(args, device="cpu",
                                     model_override=model)[4]
    tr.set_optimizer(dict(object="optim.Adam", lr=1e-3))
    return tr


def _batch3d():
    """A generated 3D global batch of B (the loaders' tuple: u_base,
    u_super, pos, cond, an empty t_cond and spatial_cond)."""
    rng = np.random.default_rng(13)
    u = (rng.random((B, 1, NT, *NX3)) + 0.5).astype(np.float32)
    cond = rng.random((B, N_STATIC3)).astype(np.float32)
    pos = np.broadcast_to(_pde3d().x.astype(np.float32)[None],
                          (B, *NX3, 3)).copy()
    empty = np.zeros((B, 0), np.float32)
    return (u, u, pos, cond, empty, empty)


def case_init(name, root):
    """JAX's side of case ``name``: (apply(params, data, steps), pde, model
    interface, criterion), one global batch of B, the initial weights (at
    the highest matmul precision) and depth-1 starts."""
    import jax
    import jax.numpy as jnp

    from nps_tpu.configs.parse import parse_args as jax_parse_args
    from nps_tpu.train.losses import build_criterion

    case = CASES[name]
    if "d3" in case:
        import nps_tpu.models as jm
        from nps_tpu.pde import PDE3D as JaxPDE3D

        pde = _pde3d(JaxPDE3D)
        model = jm.EncProcDec(pde=pde, **case["d3"])
        batch = _batch3d()
        u, pos, cond = batch[1], batch[2], batch[3]
        with jax.default_matmul_precision("highest"):
            params0 = jax.jit(lambda: model.init(
                jax.random.PRNGKey(0), u[:, :, :TW], cond=cond,
                pos=pos))()
        params0 = jax.tree_util.tree_map(np.asarray, params0)

        def apply(p, d, steps):
            return model.apply(p, d, cond=jnp.asarray(cond),
                               pos=jnp.asarray(pos))

        crit = build_criterion(object="nn.MSELoss", reduction="sum")
        return (apply, pde, model.model_interface, crit), batch, params0, \
            _steps0()

    from nps_tpu.train_cli import get_config_static as jax_build

    jt = jax_build(_case_args(name, jax_parse_args, "nps_tpu/configs/train",
                              root / "data", root / "jax", (), "jax"))[5]
    return _jax_init(jt)


def _jax_init(jt):
    """JAX's trainer ``jt``'s side of a step: (apply(params, data, steps),
    pde, model interface, criterion), one global batch of B from its
    loader, its weights (initialised at the highest matmul precision) and
    depth-1 starts."""
    import jax
    import jax.numpy as jnp

    from nps_tpu.data.pipeline import HostDataLoader as JaxHostDataLoader
    from nps_tpu.train.pushforward import window

    batch = tuple(np.asarray(a) for a in next(iter(JaxHostDataLoader(
        jt.data.train, B, seed=0, process_index=0, process_count=1))))
    with jax.default_matmul_precision("highest"):
        jt.init_params(batch)
    params0 = jax.tree_util.tree_map(np.asarray, jt.params)
    if jt.model.model_interface.name == "AR_TB_GNN":
        jt._ensure_graph_static(batch[2], B)

    def opt(a):
        return None if a is None or a.size == 0 else jnp.asarray(a)

    x, cond, tc, sc = (opt(batch[i]) for i in (2, 3, 4, 5))

    def apply(p, d, steps):
        t = None if tc is None else window(tc, steps, TW, "labels")
        return jt._apply(p, d, cond, None, x, t, sc)

    return (apply, jt.data.pde, jt.model.model_interface, jt.criterion), \
        batch, params0, _steps0()


def _steps0():
    """The depth-1 start steps of the global batch."""
    return torch.from_numpy(np.random.default_rng(5).integers(
        TW, NT - 3 * TW + 1, B))


def case_jax(init):
    """JAX's forward of the first window and its loss and gradients (in
    the port's names) of a depth-1 step from the case's starts."""
    import jax
    import jax.numpy as jnp

    from nps_tpu.train.pushforward import window
    from nps_tpu.utils.process_output import process_step
    from nps_tpu_torch.compat.jax_weights import from_jax_params

    (apply, pde, mi, crit), batch, params0, steps0 = init
    u = jnp.asarray(batch[1])

    def loss_fn(p, data, labels, steps):
        pred, _ = process_step(pde, mi, apply(p, data, steps), labels, None,
                               get_bc=False, process_settings={})
        return jnp.sqrt(crit(pred, labels))

    params = jax.tree_util.tree_map(jnp.asarray, params0)
    fwd = jax.jit(apply)
    with jax.default_matmul_precision("highest"):
        forward = np.asarray(fwd(params, u[:, :, :TW], jnp.full((B,), TW)))
        steps = jnp.asarray(steps0.numpy())
        data, labels = window(u, steps, TW, "both")
        pred = fwd(params, data, steps)
        labels_prev, steps = labels, steps + TW
        labels = window(u, steps, TW, "labels")
        data, _ = process_step(pde, mi, pred, labels_prev, labels,
                               process_settings={})
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            params, data, labels, steps)
    return dict(forward=forward, loss=float(loss),
                grads=from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                             grads)))


def case_single(name, root, init):
    """The port's single process of case ``name`` from JAX's weights (one
    thread): its forward of the first window and a depth-1 step; writes
    the weights and the inputs for the ranks."""
    _, batch, params0, steps0 = init
    with one_thread():
        return _single(case_trainer(name, root / "data", root / f"{name}_ref"),
                       root, f"{name}_", batch, params0, steps0)


def sc_cases(spec, g):
    """Each case of the spec on this rank's grid: the forward of the first
    window (every data slice's, gathered), a depth-1 step's loss, its
    gradients gathered whole, and this rank's own gradient of each
    parameter that it holds whole (replicated)."""
    out = {}
    for case in spec["cases"]:
        name = case["name"]
        tr = case_trainer(name, spec["data"], spec["out"], spec["flags"])
        tr.load_model(case["weights"])
        tr.ensure_initialized()
        c = torch.load(case["inputs"], weights_only=False)
        batch, steps0 = mine(tr, c["batch"], c["steps0"])
        with torch.no_grad():
            forward = tr.grid.gather_frames(first_window(tr, batch))
        loss, _ = tr.train_step(batch, 0, 0, unrolled=1, steps0=steps0)
        specs = tr._specs or {}
        out[name] = dict(
            forward=forward, loss=float(loss), grads=tr.whole_grads(),
            replicated={k: (torch.zeros_like(p) if p.grad is None
                            else p.grad).detach().clone()
                        for k, p in tr.model.named_parameters()
                        if specs.get(k) is None},
            numel=sum(p.numel() for p in tr.model.parameters()))
    return out


COMMON["cases"] = sc_cases


def case_runs(test_file, data_dir, single, cfg, flags, scenarios, names):
    """The file's worlds of 2 and 4 ranks (``scenarios``: n -> the
    scenarios each runs), each running every case of ``names`` too: JAX's
    weights and the port's single process of each case first, then the
    worlds in the background while JAX computes the cases' forwards and
    steps. Returns {2: world, 4: world, "single": {case: ...}, "jax":
    {case: ...}, "params0": {case: JAX's initial weights}}."""
    from concurrent.futures import ThreadPoolExecutor

    inits = {name: case_init(name, data_dir) for name in names}
    singles = {name: case_single(name, data_dir, inits[name])
               for name in names}
    cases = [dict(name=name, weights=str(singles[name]["weights"]),
                  inputs=str(singles[name]["inputs"])) for name in names]
    with ThreadPoolExecutor(2) as pool:
        worlds = {n: pool.submit(run_world, test_file, data_dir, single, n,
                                 cfg, flags,
                                 list(dict.fromkeys([*sc, "cases"])), cases)
                  for n, sc in scenarios.items()}
        jax_refs = {name: case_jax(inits[name]) for name in names}
        out = {n: w.result() for n, w in worlds.items()}
    return dict(out, single=singles, jax=jax_refs,
                params0={name: inits[name][2] for name in names})


def check_case_forward(world, name, single, jax_ref):
    """Case ``name``'s forward on every rank of ``world`` against the port's
    single process and JAX."""
    for res in world["ranks"]:
        got = res["cases"][name]["forward"]
        assert got.shape == single["forward"].shape
        assert _rel(got, single["forward"]) <= REL_FWD
        assert _rel(got, jax_ref["forward"]) <= REL_JAX_FWD


def check_case_step(world, name, single):
    """Case ``name``'s depth-1 step on every rank against the port's single
    process: the loss, every gradient gathered whole, and every gradient
    the rank holds whole (replicated) as it is on the rank."""
    floor = 1e-3 * max(float(r.abs().max()) for r in single["grads"].values())
    for res in world["ranks"]:
        got = res["cases"][name]
        np.testing.assert_allclose(got["loss"], single["loss"],
                                   rtol=REL_LOSS)
        _assert_grads_close(got["grads"], single["grads"], REL_GRAD, 1e-3)
        for k, g in got["replicated"].items():
            ref = single["grads"][k]
            scale = max(float(ref.abs().max()), floor)
            err = float((g.double() - ref.double()).abs().max()) / scale
            assert err <= REL_GRAD, (k, err)


def check_case_step_jax(world, name, jax_ref):
    """Case ``name``'s step against jax.grad of the JAX loss."""
    for res in world["ranks"]:
        got = res["cases"][name]
        np.testing.assert_allclose(got["loss"], jax_ref["loss"],
                                   rtol=REL_JAX_LOSS)
        _assert_grads_close(got["grads"], jax_ref["grads"], REL_JAX_GRAD,
                            1e-5)
