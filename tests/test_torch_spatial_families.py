"""Spatial parallelism of every family the JAX grid mesh takes
(``nps_tpu_torch.parallel.spatial``): the mixture of spectral experts with
a conditioned gate and with a pooled one, the U-Net with attention, the
time-conditioned U-FNO (a BC encoder), the 3D FNO, DRN and MoE, split over
the rows of an x axis; the MP-GNN and a 1D FNO whole on each x rank;
``simulate()`` on a row-split trainer; the evaluation of the 3D models;
``SurrogateEngine.shard(2)`` for the MoE, the attention U-Net, a 1D model
and the 3D models. Real gloo worlds on the CPU of K = 2 (two processes)
and of D = 2 data slices x K = 2 (four); each world runs every case, each
rank this file run as a script (``python
tests/test_torch_spatial_families.py --worker SPEC``) on one thread.

Sizes: the twophase configs at a 16 x 16 grid (8 rows a rank), time
window 5, 21 frames, a global batch of 4 (the FNO families 2 blocks x 16
features, 4 modes; the U-Net 16 features, ``ch_mults=[2,1]``, attention
on both levels and in the middle (at 8 features its final GroupNorm(8)
normalises each channel alone, so the last attention's output bias has a
gradient of exactly zero, which each side computes as round-off near 1e-7
of the largest gradient: no relative bar reads it); the time-conditioned
U-FNO 8 features with
a BC encoder of 4 outputs over a 2-channel ``t_conditioning`` memmap; the
MP-GNN 2 x 16); ``cfg_var1d_fno`` at 2 x 16, 4 modes, on 12 ragged
simulations of 20-50 frames on 32 points; the 3D cases are the grid
harness's (``torch_grid_harness.CASES``: 8 x 8 x 8, 2 blocks x 16
features, 2 modes, on a generated batch through the U-FNO config's
trainer; 4 rows a rank).

Bars: against the port's single process (one thread) the forward and the
frames max|d| / max|ref| <= 1e-5, the loss and the simulated losses rtol
1e-5, every gradient 1e-4 of max(its own max |ref|, 1e-3 of the largest)
(5e-5 for the 3D cases, the grid harness's bar);
against ``nps_tpu`` on the same numpy inputs and converted weights (f32,
precision "highest") the forward 1e-4, the loss 2e-3, the gradients 5e-3
above a floor of 1e-5 of the largest, a rollout's nRMSE 1e-3 (the ROADMAP
bars).
"""

import contextlib
import io
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_distributed import (  # noqa: E402
    _assert_grads_close, _assert_ok, _parse, _rel, _rendezvous, _run_world,
    _tensors)
from torch_grid_harness import (  # noqa: E402
    CASES as GRID_CASES, NX3, _parse_none, _pde3d, case_init, case_jax,
    case_single, case_trainer, mine, one_thread)
from torch_grid_harness import REL_GRAD as REL_GRAD_3D  # noqa: E402

NT, TW, NX, B, K = 21, 5, 16, 4, 2
V1_NX, V1_T_MIN, V1_T_MAX = 32, 4 * TW, 10 * TW
N_TC = 2
REL_FWD, REL_LOSS, REL_GRAD = 1e-5, 1e-5, 1e-4
REL_JAX_FWD, REL_JAX_LOSS, REL_JAX_GRAD, NRMSE = 1e-4, 2e-3, 5e-3, 1e-3
WORKER_TIMEOUT = 420
ROLLOUT_STEPS = 3
FNO16 = ["--model.hidden_features=16", "--model.hidden_blocks=2",
         "--model.fno_modes=4"]
# name -> (port config, JAX config (None: built from the U-FNO's, as
# test_torch_conditioning builds it), model flags, data, what else runs)
CASES = {
    "moe": ("cfg_twophase_moe.py", "cfg_twophase_moe.py", FNO16, "2d",
            ("engine",)),
    "moe_pooled": ("cfg_twophase_moe.py", "cfg_twophase_moe.py",
                   [*FNO16, "--dataset.conditioning=None"], "2d", ()),
    "unet_attn": ("cfg_twophase_unet.py", "cfg_twophase_unet.py", [
        "--model.hidden_features=16", "--model.ch_mults=[2,1]",
        "--model.is_attn=[True,True]", "--model.mid_attn=true"], "2d",
        ("engine",)),
    "ufno_tcond": ("cfg_twophase_ufno_tcond.py", None, [
        "--model.hidden_features=8", "--model.hidden_blocks=2",
        "--model.fno_modes=4", "--model.bc_encoder.bc_encoder_out=4",
        "--model.bc_encoder.bc_encoder_hidden=8"], "2d", ("simulate",)),
    "gnn": ("cfg_twophase_gnn.py", "cfg_twophase_gnn.py", [
        "--model.hidden_features=16", "--model.hidden_blocks=2"], "2d", ()),
    "var1d": ("cfg_var1d_fno.py", "cfg_var1d_fno.py", FNO16, "1d",
              ("engine",)),
    # the grid harness's 3D cases (its CASES' "d3" specs)
    "fno3d": (None, None, [], "3d", ("eval", "engine")),
    "drn3d": (None, None, [], "3d", ("eval", "engine")),
    "moe3d": (None, None, [], "3d", ("eval", "engine")),
}
D3 = [name for name in CASES if CASES[name][3] == "3d"]
GRID_FLAGS = ["--trainer.data_parallel=true",
              f"--trainer.spatial_parallel={K}"]
WHOLE = {"gnn": "the MP-GNN", "var1d": "a 1D model"}


def _port_cfg(name):
    return f"nps_tpu_torch/configs/train/{CASES[name][0]}"


def _argv(name, root, out):
    """The case's command line (its data under ``root``)."""
    _, _, flags, data, _ = CASES[name]
    common = [f"--dataset.base_path={root / 'data'}",
              f"--experiment_path={out}", "--experiment_name=run",
              f"--batch_size={B}", f"--time_window={TW}",
              "--trainer.lr_step_interval=1", "--trainer.unrolling=1"]
    if data == "1d":
        return [*common, *flags]
    return [f"--base_resolution=[{NT},{NX},{NX}]",
            f"--super_resolution=[{NT},{NX},{NX}]",
            "--dataset.c_filter=[0]", *common, *flags]


def _port_trainer(name, argv, k=0):
    """The case's trainer as the CLI builds it, on the CPU, with Adam;
    ``k`` > 0 asks for data_parallel and spatial_parallel=k (set in the
    parsed config: cfg_var1d_fno, like its JAX original, has no such key)."""
    from nps_tpu_torch import train_cli
    from nps_tpu_torch.configs.parse import parse_args

    args = _parse_none(parse_args, _port_cfg(name), argv)
    if k:
        args["trainer"].update(data_parallel=True, spatial_parallel=k)
    tr = train_cli.get_config_static(args, device="cpu")[4]
    tr.set_optimizer(dict(object="optim.Adam", lr=1e-3))
    return tr


def _window(t, steps):
    """The labels' window of ``t_cond`` [b, c, t] at ``steps``, or None."""
    if t is None or t.numel() == 0:
        return None
    return torch.stack([t[i, :, s:s + TW]
                        for i, s in enumerate(steps.tolist())])


def _first_window(tr, t):
    """The model's apply to the first window of the batch tensors ``t``
    (its labels' window of t_cond)."""
    steps = torch.full((t[1].shape[0],), TW)
    tr._ensure_graph_static(t[2], t[1].shape[0])
    return tr._apply(t[1][:, :, :TW], t[3], None, t[2], _window(t[4], steps),
                     t[5] if len(t) > 5 else None)


def _pde(name):
    from nps_tpu_torch.pde import PDE1D, PDE2D

    if CASES[name][3] == "1d":
        return PDE1D(tmin=0.0, tmax=10.0, nt=V1_T_MAX, L=1.0, nx=V1_NX,
                     x=None, name="var1d", n_cond_static=2)
    return PDE2D(tmin=0, tmax=1, nt=NT, L1=1.0, L2=1.0, nx1=NX, nx2=NX,
                 x=None, name="twophase", n_cond_static=2, n_cond_spatial=2)


def _engine_overrides(name):
    return [f"--time_window={TW}", *CASES[name][2]]


def _rollout_inputs(name):
    rng = np.random.default_rng(11)
    if CASES[name][3] == "3d":
        return ((0.1 + 0.8 * rng.random((B, 1, TW, *NX3))).astype(
            np.float32), rng.random((B, 2), dtype=np.float32), None)
    if CASES[name][3] == "1d":
        return (rng.random((B, 2, TW, V1_NX), dtype=np.float32),
                rng.random((B, 2), dtype=np.float32), None)
    return ((0.1 + 0.8 * rng.random((B, 1, TW, NX, NX))).astype(np.float32),
            rng.random((B, 2), dtype=np.float32),
            (rng.random((B, 2, NX, NX)) > 0.8).astype(np.float32))


def _port_engine(name, weights):
    from nps_tpu_torch.inference import SurrogateEngine

    if CASES[name][3] == "3d":
        from nps_tpu_torch.models.enc_proc_dec import EncProcDec

        pde = _pde3d()
        eng = SurrogateEngine(EncProcDec(pde=pde, **GRID_CASES[name]["d3"]),
                              pde, TW, device="cpu")
        return eng.load(weights)
    eng = SurrogateEngine.from_config(_port_cfg(name), pde=_pde(name),
                                      overrides=_engine_overrides(name),
                                      device="cpu")
    return eng.load(weights)


def _simulate_kw(batch):
    _, u, x, cond, tc, sc = (np.asarray(a) for a in batch[:6])
    return (u, cond, x), dict(compute_loss=True, include_data=True,
                              nr_gt_steps=1, t_res=NT, t_conditioning=tc,
                              spatial_conditioning=sc)


# ---------------------------------------------------------------- workers
def _run_case(spec, case):
    """One case on this rank's grid: the forward of the first window and a
    depth-1 step on its rows of its data slice, and what else the case
    runs (the evaluation and the saved weights, the sharded engine's
    rollout, ``simulate``)."""
    from nps_tpu_torch.parallel import spatial

    name = case["name"]
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        if CASES[name][3] == "3d":
            tr = case_trainer(name, os.path.join(case["root"], "data"),
                              spec["out"], GRID_FLAGS)
        else:
            tr = _port_trainer(name, case["argv"], K)
    tr.load_model(case["weights"])
    tr.ensure_initialized()
    g = torch.load(case["inputs"], weights_only=False)
    whole, steps0 = mine(tr, g["batch"], g["steps0"])
    batch = tr.grid.shard_batch(whole)
    out = {"whole": tr.grid.whole, "log": log.getvalue(),
           "rows": int(batch[1].shape[3])}
    spatial.traffic.clear()
    with torch.no_grad():
        out["forward"] = tr.grid.gather_frames(_first_window(tr, batch))
    loss, _ = tr.train_step(batch, 0, 0, unrolled=1, steps0=steps0)
    out["step"] = dict(loss=float(loss), grads=tr.whole_grads())
    out["traffic"] = dict(spatial.traffic)
    if "eval" in CASES[name][4]:
        # the loaded weights again (the step moved them); the trainer cuts
        # this rank's rows of its data slice itself
        tr.load_model(case["weights"])
        loss, stats = tr.test([whole])
        saved = os.path.join(spec["out"], f"{name}_saved.pt")
        tr.save_model(saved)
        out["eval"] = dict(loss=loss, stats=stats, saved=saved)
    if name == "moe3d":
        out["pooled"] = _pooled_split(tr)
    if "simulate" in CASES[name][4]:
        tr.load_model(case["weights"])
        args, kw = _simulate_kw(g["batch"])
        losses, (gt, pred) = tr.simulate(*args, **kw)
        out["simulate"] = dict(losses=losses, gt=gt, pred=pred)
    if "engine" in CASES[name][4]:
        eng = _port_engine(name, case["weights"]).shard(K)
        u0, cond, sc = _rollout_inputs(name)
        spatial.traffic.clear()
        out["engine"] = dict(frames=eng.rollout(u0, ROLLOUT_STEPS, cond=cond,
                                                spatial_cond=sc),
                             traffic=dict(spatial.traffic))
    return out


def _pooled_split(tr):
    """The 3D MoE's pooled gate input (the grid mean) of a field split over
    the x group against the whole field's mean: max|d| / max|ref|."""
    from nps_tpu_torch.parallel import spatial

    proc = next(m for m in tr.model.modules() if hasattr(m, "_pooled"))
    h = torch.from_numpy(np.random.default_rng(17).standard_normal(
        (2, 3, *NX3)).astype(np.float32))
    ref = proc._pooled(h)
    lo, hi = tr.grid.axis.part(NX3[0])
    with spatial.scope(tr.grid.axis.at(NX3[0])):
        got = proc._pooled(h[:, :, lo:hi])
    return _rel(got, ref)


def _worker(spec_path):
    from nps_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    init_distributed(spec["rendezvous"], world_size=spec["world"],
                     rank=spec["rank"], device="cpu", timeout=WORKER_TIMEOUT)
    try:
        res = {case["name"]: _run_case(spec, case) for case in spec["cases"]}
        torch.save(res, f"{spec['out']}/r{spec['rank']}.pt")
    finally:
        torch.distributed.destroy_process_group()


def _world(root, n, cases):
    """Start a world of ``n`` ranks running every case; return each rank's
    results and output."""
    out = root / f"world{n}"
    out.mkdir()
    rendezvous = _rendezvous(out)
    commands = []
    for rank in range(n):
        spec = out / f"spec{rank}.json"
        spec.write_text(json.dumps(dict(
            rank=rank, world=n, rendezvous=rendezvous, out=str(out),
            cases=cases)))
        commands.append([sys.executable, os.path.abspath(__file__),
                         "--worker", str(spec)])
    results = _run_world(commands, WORKER_TIMEOUT)
    _assert_ok(results)
    return [dict(torch.load(out / f"r{r}.pt", weights_only=False),
                 output=text) for r, (_, text) in enumerate(results)]


# ------------------------------------------------------------ references
def _jax_args(name, argv):
    from nps_tpu.configs.parse import parse_args as jax_parse_args

    if CASES[name][1] is None:
        from test_torch_conditioning import _jax_args as tcond_args

        return tcond_args(argv)
    return _parse_none(jax_parse_args,
                       f"nps_tpu/configs/train/{CASES[name][1]}", argv)


def _jax_init(name, root):
    """JAX's trainer for the case, one global batch of B from its loader
    (the var-t loader's first min-cropped batch in 1D), its weights
    (initialised at the highest matmul precision) and depth-1 starts."""
    import jax

    from nps_tpu.data.pipeline import HostDataLoader as JaxHostDataLoader
    from nps_tpu.train_cli import get_config_static as jax_build

    jt = jax_build(_jax_args(name, _argv(name, root, root / "jax")))[5]
    if CASES[name][3] == "1d":
        batch = next(iter(jt.get_dataloaders()[0]))
    else:
        batch = next(iter(JaxHostDataLoader(jt.data.train, B, seed=0,
                                            process_index=0,
                                            process_count=1)))
    batch = tuple(np.asarray(a) for a in batch)
    with jax.default_matmul_precision("highest"):
        jt.init_params(batch)
    params0 = jax.tree_util.tree_map(np.asarray, jt.params)
    t_res = batch[1].shape[2]
    steps0 = torch.from_numpy(np.random.default_rng(5).integers(
        TW, t_res - 3 * TW + 1, B))
    return jt, batch, params0, steps0


def _jax_forward_step(jt, batch, params0, steps0):
    """JAX's forward of the first window and its loss and gradients (in
    the port's names) of a depth-1 step from ``steps0``, each apply with
    its labels' window of t_cond (``jt._apply``: the MP-GNN's graph too)."""
    import jax
    import jax.numpy as jnp

    from nps_tpu.train.pushforward import window
    from nps_tpu.utils.process_output import process_step
    from nps_tpu_torch.compat.jax_weights import from_jax_params

    def opt(a):
        return None if a is None or a.size == 0 else jnp.asarray(a)

    u, x, cond, tc = (jnp.asarray(batch[i]) for i in (1, 2, 3, 4))
    cond, sc = opt(batch[3]), opt(batch[5])
    tc = opt(batch[4])
    if jt.model.model_interface.name == "AR_TB_GNN":
        jt._ensure_graph_static(batch[2], B)
    pde, mi = jt.data.pde, jt.model.model_interface

    def apply(p, d, steps):
        t = None if tc is None else window(tc, steps, TW, "labels")
        return jt._apply(p, d, cond, None, x, t, sc)

    def loss_fn(p, data, labels, steps):
        pred, _ = process_step(pde, mi, apply(p, data, steps), labels, None,
                               get_bc=False, process_settings={})
        return jnp.sqrt(jt.criterion(pred, labels))

    params = jax.tree_util.tree_map(jnp.asarray, params0)
    with jax.default_matmul_precision("highest"):
        forward = np.asarray(apply(params, u[:, :, :TW],
                                   jnp.full((B,), TW)))
        steps = jnp.asarray(steps0.numpy())
        data, labels = window(u, steps, TW, "both")
        pred = apply(params, data, steps)
        labels_prev, steps = labels, steps + TW
        labels = window(u, steps, TW, "labels")
        data, _ = process_step(pde, mi, pred, labels_prev, labels,
                               process_settings={})
        loss, grads = jax.value_and_grad(loss_fn)(params, data, labels,
                                                  steps)
    return dict(forward=forward, loss=float(loss),
                grads=from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                             grads)))


def _jax_extras(name, jt, batch, params0):
    """JAX's simulate() of the batch and its engine's rollout, where the
    case runs them."""
    import jax
    import jax.numpy as jnp

    out = {}
    jt.params = jax.tree_util.tree_map(jnp.asarray, params0)
    if "simulate" in CASES[name][4]:
        args, kw = _simulate_kw(batch)
        with jax.default_matmul_precision("highest"):
            losses, (_, pred) = jt.simulate(*args, **kw)
        out["simulate"] = dict(losses=np.asarray(losses), pred=pred)
    if "engine" in CASES[name][4]:
        from nps_tpu.inference import SurrogateEngine as JaxEngine
        from nps_tpu.pde import PDE1D as JaxPDE1D
        from nps_tpu.pde import PDE2D as JaxPDE2D

        p = _pde(name)
        pde = (JaxPDE1D(tmin=0.0, tmax=10.0, nt=V1_T_MAX, L=1.0, nx=V1_NX,
                        x=None, name="var1d", n_cond_static=2)
               if CASES[name][3] == "1d" else
               JaxPDE2D(tmin=0, tmax=1, nt=NT, L1=1.0, L2=1.0, nx1=NX,
                        nx2=NX, x=None, name="twophase", n_cond_static=2,
                        n_cond_spatial=2))
        assert p.name == pde.name
        eng = JaxEngine.from_config(
            f"nps_tpu/configs/train/{CASES[name][1]}", pde=pde,
            overrides=_engine_overrides(name))
        eng.params = jax.tree_util.tree_map(jnp.asarray, params0)
        u0, cond, sc = _rollout_inputs(name)
        with jax.default_matmul_precision("highest"):
            out["rollout"] = np.asarray(eng.rollout(
                u0, n_steps=ROLLOUT_STEPS, cond=cond, spatial_cond=sc))
    return out


def _single(name, root, params0, batch, steps0):
    """The port's single-process trainer from JAX's weights (one thread):
    its forward of the first window, a depth-1 step, and where the case
    runs them its simulate() and its one-device engine's rollout; writes
    the weights and the inputs for the ranks."""
    with one_thread():
        tr = _port_trainer(name, _argv(name, root, root / f"{name}_ref"))
        tr.load_jax_params(params0)
        tr.ensure_initialized()
        weights = root / f"{name}_weights.pt"
        torch.save(tr.model.state_dict(), weights)
        inputs = root / f"{name}_inputs.pt"
        torch.save(dict(batch=batch, steps0=steps0), inputs)
        t = _tensors(batch)
        with torch.no_grad():
            forward = _first_window(tr, t)
        loss, _ = tr.train_step(t, 0, 0, unrolled=1, steps0=steps0)
        out = dict(forward=forward, loss=float(loss), grads=tr.whole_grads(),
                   weights=str(weights), inputs=str(inputs))
        if "simulate" in CASES[name][4]:
            tr.load_model(str(weights))
            args, kw = _simulate_kw(batch)
            losses, (gt, pred) = tr.simulate(*args, **kw)
            out["simulate"] = dict(losses=losses, gt=gt, pred=pred)
        if "engine" in CASES[name][4]:
            u0, cond, sc = _rollout_inputs(name)
            out["rollout"] = _port_engine(name, str(weights)).rollout(
                u0, ROLLOUT_STEPS, cond=cond, spatial_cond=sc)
    return out


def _single_3d(name, root, init):
    """A 3D case's single process from JAX's weights (one thread): the
    grid harness's forward and depth-1 step, then the evaluation of the
    case's batch and the one-device engine's rollout."""
    out = case_single(name, root, init)
    weights = str(out["weights"])
    with one_thread():
        tr = case_trainer(name, root / "data", root / f"{name}_ref")
        tr.load_model(weights)
        loss, stats = tr.test([_tensors(init[1])])
        u0, cond, _ = _rollout_inputs(name)
        rollout = _port_engine(name, weights).rollout(u0, ROLLOUT_STEPS,
                                                      cond=cond)
    return dict(out, weights=weights, inputs=str(out["inputs"]),
                eval=dict(loss=loss, stats=stats), rollout=rollout)


def _jax_rollout_3d(name, params0):
    """JAX's engine's rollout of a 3D case from its weights."""
    import jax
    import jax.numpy as jnp

    import nps_tpu.models as jm
    from nps_tpu.inference import SurrogateEngine as JaxEngine
    from nps_tpu.pde import PDE3D as JaxPDE3D

    pde = _pde3d(JaxPDE3D)
    eng = JaxEngine(jm.EncProcDec(pde=pde, **GRID_CASES[name]["d3"]),
                    jax.tree_util.tree_map(jnp.asarray, params0), pde, TW)
    u0, cond, _ = _rollout_inputs(name)
    with jax.default_matmul_precision("highest"):
        return np.asarray(eng.rollout(u0, n_steps=ROLLOUT_STEPS, cond=cond))


# ------------------------------------------------------------ fixtures
@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """The twophase split at 16 x 16 (20 simulations: 16/2/2) with a
    ``t_conditioning`` memmap beside it, and a ragged 1D split."""
    from nps_tpu_torch.data.synthetic import generate, generate_var_t
    from test_torch_conditioning import write_t_conditioning

    root = tmp_path_factory.mktemp("spatial_families")
    generate(str(root / "data" / "twophase"), n_sims=20, n_channels=1,
             nt=NT, nx1=NX, nx2=NX, seed=3)
    write_t_conditioning(root / "data" / "twophase", 20, NT, 5)
    generate_var_t(str(root / "data" / "var1d"), n_sims=12, n_channels=2,
                   nx=V1_NX, t_min=V1_T_MIN, t_max=V1_T_MAX, seed=7)
    return root


@pytest.fixture(scope="module")
def runs(data_dir):
    """Every case's JAX weights, batch and starts; the port's single
    process from them; then the worlds of 2 and 4 ranks running every case
    (in the background) while JAX computes its forwards, steps, simulate
    and rollouts."""
    inits, single = {}, {}
    for name in CASES:
        if name in D3:
            inits[name] = case_init(name, data_dir)
            single[name] = _single_3d(name, data_dir, inits[name])
            continue
        inits[name] = _jax_init(name, data_dir)
        _, batch, params0, steps0 = inits[name]
        single[name] = _single(name, data_dir, params0, batch, steps0)
    cases = [dict(name=name, argv=_argv(name, data_dir, data_dir / "w"),
                  root=str(data_dir), weights=single[name]["weights"],
                  inputs=single[name]["inputs"]) for name in CASES]
    with ThreadPoolExecutor(2) as pool:
        worlds = {n: pool.submit(_world, data_dir, n, cases) for n in (2, 4)}
        jax_ref = {}
        for name, init in inits.items():
            if name in D3:
                jax_ref[name] = dict(case_jax(init), rollout=_jax_rollout_3d(
                    name, init[2]))
                continue
            jt, batch, params0, steps0 = init
            jax_ref[name] = dict(_jax_forward_step(jt, batch, params0,
                                                   steps0),
                                 **_jax_extras(name, jt, batch, params0))
        worlds = {n: w.result() for n, w in worlds.items()}
    return dict(single=single, jax=jax_ref, worlds=worlds)


# ------------------------------------------------------------------ tests
CASE_N = [(name, n) for name in CASES for n in (2, 4)]


@pytest.mark.parametrize("name,n", CASE_N)
def test_forward_matches_single_process_and_jax(runs, name, n):
    """The forward of the first window on the grid (gathered in global
    order) equals the port's single-process forward and nps_tpu's."""
    ref, jref = runs["single"][name]["forward"], runs["jax"][name]["forward"]
    for res in runs["worlds"][n]:
        got = res[name]["forward"]
        assert got.shape == ref.shape == jref.shape
        assert _rel(got, ref) <= REL_FWD
        assert _rel(got, jref) <= REL_JAX_FWD


@pytest.mark.parametrize("name,n", CASE_N)
def test_step_matches_single_process(runs, name, n):
    """A depth-1 step on the grid: the loss and every gradient equal the
    single-process step's, on every rank."""
    ref = runs["single"][name]
    bar = REL_GRAD_3D if name in D3 else REL_GRAD
    for res in runs["worlds"][n]:
        got = res[name]["step"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=REL_LOSS)
        _assert_grads_close(got["grads"], ref["grads"], bar, 1e-3)


@pytest.mark.parametrize("name,n", CASE_N)
def test_step_matches_jax(runs, name, n):
    """The same step's loss and gradients against jax.grad of the JAX loss
    on the global batch, from the same weights and starts."""
    ref = runs["jax"][name]
    for res in runs["worlds"][n]:
        got = res[name]["step"]
        np.testing.assert_allclose(got["loss"], ref["loss"],
                                   rtol=REL_JAX_LOSS)
        _assert_grads_close(got["grads"], ref["grads"], REL_JAX_GRAD, 1e-5)


@pytest.mark.parametrize("name", sorted(WHOLE))
def test_whole_families_run_whole_on_each_x_rank(runs, name):
    """The MP-GNN and the 1D model run whole on each x rank, and say so:
    the grid names the family, the trainer's log line says "whole on each
    x rank", each rank holds every row, and no row is fetched nor any sum
    taken over the x group (in the step, nor in a 1D model's sharded
    rollout)."""
    for n in (2, 4):
        for res in runs["worlds"][n]:
            got = res[name]
            assert got["whole"] == WHOLE[name] or got["whole"].startswith(
                WHOLE[name])
            assert "whole on each x rank" in got["log"]
            assert got["traffic"] == {}
            assert got["forward"].shape == runs["single"][name][
                "forward"].shape
            if "engine" in got:
                assert got["engine"]["traffic"] == {}


@pytest.mark.parametrize("name", [c for c in CASES if c not in WHOLE])
def test_row_split_families_split_their_rows(runs, name):
    """The other cases hold half the rows a rank and fetch and sum over the
    x group; the attention U-Net's softmax takes its shift over the group
    (a MAX all-reduce) and fetches every row of its keys and values."""
    rows = (NX3[0] if name in D3 else NX) // K
    for res in runs["worlds"][2]:
        got = res[name]
        assert got["whole"] is None and got["rows"] == rows
        assert got["traffic"].get("fetch", 0) + got["traffic"].get("sum", 0)
        assert ("max" in got["traffic"]) == (name == "unet_attn")


@pytest.mark.parametrize("n", [2, 4])
def test_simulate_on_a_row_split_trainer(runs, n):
    """simulate() on the time-conditioned U-FNO's row-split trainer: every
    rank returns the single process's losses and frames (the whole field),
    and JAX's simulate() of the same weights and inputs."""
    ref = runs["single"]["ufno_tcond"]["simulate"]
    jref = runs["jax"]["ufno_tcond"]["simulate"]
    for res in runs["worlds"][n]:
        got = res["ufno_tcond"]["simulate"]
        assert got["pred"].shape == ref["pred"].shape == jref["pred"].shape
        assert _rel(got["pred"], ref["pred"]) <= REL_FWD
        np.testing.assert_array_equal(got["gt"], ref["gt"])
        np.testing.assert_allclose(got["losses"], ref["losses"],
                                   rtol=REL_LOSS)
        np.testing.assert_allclose(got["losses"], jref["losses"],
                                   rtol=REL_JAX_LOSS)
        nrmse = np.sqrt(np.mean((got["pred"] - jref["pred"]) ** 2)
                        / np.mean(jref["pred"] ** 2))
        assert nrmse < NRMSE


@pytest.mark.parametrize("name,n", [(c, n) for c in CASES
                                    if "engine" in CASES[c][4]
                                    for n in (2, 4)])
def test_shard_rollout_matches_one_device_and_jax(runs, name, n):
    """``SurrogateEngine.shard(2)``: the rollout's frames on every rank
    equal the one-device engine's, and JAX's engine's (nRMSE)."""
    ref, jref = runs["single"][name]["rollout"], runs["jax"][name]["rollout"]
    for res in runs["worlds"][n]:
        got = res[name]["engine"]["frames"]
        assert got.shape == ref.shape == jref.shape
        assert _rel(got, ref) <= REL_FWD
        nrmse = np.sqrt(np.mean((got - jref) ** 2) / np.mean(jref ** 2))
        assert nrmse < NRMSE


@pytest.mark.parametrize("name,n", [(c, n) for c in D3 for n in (2, 4)])
def test_3d_evaluation_and_saved_weights_match_single_process(runs, name, n):
    """The evaluation of a 3D case's batch on the row-split trainer (its
    loss and every per-step loss and metric) equals the single process's,
    and the weights it saves are the loaded ones, bit for bit."""
    ref = runs["single"][name]["eval"]
    want = torch.load(runs["single"][name]["weights"], weights_only=True)
    for res in runs["worlds"][n]:
        got = res[name]["eval"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=REL_LOSS)
        assert set(got["stats"]) == set(ref["stats"])
        for k, v in ref["stats"].items():
            np.testing.assert_allclose(got["stats"][k], v, rtol=REL_LOSS,
                                       err_msg=k)
        saved = torch.load(got["saved"], weights_only=True)
        assert list(saved) == list(want)
        assert all(torch.equal(saved[k], v) for k, v in want.items())


def test_3d_pooled_gate_is_the_grid_mean(runs):
    """The 3D MoE's pooled gate input on a row split (the local rows'
    sums summed over the x group, over the grid's cell count) is the
    whole field's mean, on every rank of both worlds."""
    for n in (2, 4):
        for res in runs["worlds"][n]:
            assert res["moe3d"]["pooled"] <= 1e-6


def test_mpgnn_shard_is_refused_as_in_jax():
    """The MP-GNN under ``shard`` stays refused, as the JAX engine's
    ``shard`` refuses it (its graph is built per batch size)."""
    from nps_tpu_torch.inference import SurrogateEngine

    eng = SurrogateEngine.from_config(
        _port_cfg("gnn"), pde=_pde("gnn"), overrides=_engine_overrides("gnn"),
        device="cpu")
    with pytest.raises(NotImplementedError, match="JAX engine"):
        eng.shard(K)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(sys.argv[2])
