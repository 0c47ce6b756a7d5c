"""The mixture-of-spectral-experts FNO (``cfg_twophase_moe``) against
``nps_tpu``: both trainers and engines built by their own packages from
their own configs at a small size (2 blocks x 4 experts x 16 features, 4
modes, 16x16 grid, time window 5, 21 frames), JAX weights carried into the
port by ``from_jax_params``, which splits the experts' stacked axis.

Bars (ROADMAP "How a part is held"): forward max|d| / max|ref| < 1e-4;
3-step rollout nRMSE < 1e-3; train-step loss rtol 2e-3 at injected depths 0
and 1; every gradient max|d| / max|ref| < 5e-3 (``jax.grad`` of the JAX
loss). With one expert the block is exactly an FNO layer: the port's
``MoEFNO`` equals its ``FNO`` processor bit for bit. JAX runs at precision
"highest"; PyTorch on two threads, since the suite's workers share the
machine's cores. In bf16 the bar is ``tests/test_torch_dtype.py``'s: with
d_jax = max|JAX_bf16 - JAX_f32| / max|JAX_f32|, the port in bf16 against
JAX in bf16 within max(2 d_jax, 8e-3) of max|JAX_f32|.
"""

import json
import re
import sys
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nps_tpu.configs.parse import parse_args as jax_parse_args
from nps_tpu.data.pipeline import HostDataLoader as JaxHostDataLoader
from nps_tpu.inference import SurrogateEngine as JaxEngine
from nps_tpu.models import config as jconfig
from nps_tpu.models.moe_fno import MoEFNO as JaxMoEFNO
from nps_tpu.pde import PDE2D as JaxPDE2D
from nps_tpu.train.pushforward import window
from nps_tpu.train_cli import get_config_static as jax_build
from nps_tpu.utils.process_output import process_step as jax_process_step
from nps_tpu_torch import train_cli
from nps_tpu_torch.compat.jax_weights import from_jax_params
from nps_tpu_torch.configs.parse import parse_args as port_parse_args
from nps_tpu_torch.data.synthetic import generate
from nps_tpu_torch.inference import SurrogateEngine
from nps_tpu_torch.models.fno import (FNO, SpectralConvND,
                                      packed_spectral_weights)
from nps_tpu_torch.models import config as tconfig
from nps_tpu_torch.models.moe_fno import MoEFNO
from nps_tpu_torch.pde import PDE2D
from nps_tpu_torch.train import base as train_base

JAX_CFG = "nps_tpu/configs/train/cfg_twophase_moe.py"
PORT_CFG = "nps_tpu_torch/configs/train/cfg_twophase_moe.py"
NT, NX, TW, B, E = 21, 16, 5, 2, 4
DEPTHS = (0, 1)
REL_FWD, NRMSE, REL_LOSS, REL_GRAD = 1e-4, 1e-3, 2e-3, 5e-3
BF16_FLOOR = 8e-3
SMALL = ["--model.hidden_features=16", "--model.hidden_blocks=2",
         "--model.fno_modes=4"]
PDE_KW = dict(tmin=0, tmax=10, nt=NT, L1=1.0, L2=1.0, nx1=NX, nx2=NX,
              x=None, name="twophase", n_cond_static=2, n_cond_spatial=2)


def _parse(fn, cfg, argv):
    saved = sys.argv
    try:
        sys.argv = ["prog", *argv]
        return fn(cfg)
    finally:
        sys.argv = saved


def _rel(a, ref):
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe")
    generate(str(root / "data" / "twophase"), n_sims=8, n_channels=1, nt=NT,
             nx1=NX, nx2=NX, seed=3)
    return root


def _argv(data_dir, extra=()):
    return [f"--base_resolution=[{NT},{NX},{NX}]",
            f"--super_resolution=[{NT},{NX},{NX}]",
            f"--time_window={TW}", f"--batch_size={B}",
            f"--dataset.base_path={data_dir / 'data'}",
            "--dataset.c_filter=[0]", *SMALL,
            f"--experiment_path={data_dir / 'out'}",
            "--experiment_name=run", *extra]


@pytest.fixture(scope="module")
def trainers(data_dir):
    """Both trainers on the same split, the port's weights carried over
    from the JAX model's, and one batch."""
    argv = _argv(data_dir)
    jt = jax_build(_parse(jax_parse_args, JAX_CFG, argv))[5]
    pt = train_cli.get_config_static(_parse(port_parse_args, PORT_CFG, argv),
                                     device="cpu")[4]
    loader = JaxHostDataLoader(jt.data.train, B, seed=0, process_index=0,
                               process_count=1)
    batch = next(iter(loader))
    with jax.default_matmul_precision("highest"):
        jt.init_params(batch)
    params0 = jax.tree_util.tree_map(np.asarray, jt.params)
    pt.load_jax_params(params0)
    pt.set_optimizer(dict(object="optim.Adam", lr=1e-4))
    return jt, pt, batch, params0


def _inputs(seed=0, b=B):
    rng = np.random.default_rng(seed)
    u0 = (0.1 + 0.8 * rng.random((b, 1, TW, NX, NX))).astype(np.float32)
    cond = rng.random((b, 2)).astype(np.float32)
    sc = (rng.random((b, 2, NX, NX)) > 0.8).astype(np.float32)
    return u0, cond, sc


def test_config_parses_to_the_jax_dict():
    """The port's config parses to the JAX config's groups, key for key
    (activation objects by class name)."""
    def parse(fn, cfg):
        args = _parse(fn, cfg, [])
        return {g: {k: (type(v).__name__ if hasattr(v, "_parse_override")
                        else v) for k, v in args[g].items()}
                if isinstance(args[g], dict) else args[g] for g in args}

    assert parse(port_parse_args, PORT_CFG) == parse(jax_parse_args, JAX_CFG)


def test_weight_bridge_splits_the_expert_axis(trainers):
    """Every JAX leaf lands in the port's state_dict with its shape, the
    stacked expert axis split: expert e of block i's 1x1 conv kernel
    ``[E, 1, 1, I, O]`` becomes ``experts.i.e.w.weight [O, I, 1, 1]`` (a 2D
    conv, not a 3D one), its spectral weights ``[E, 2, I, O, m, m]``
    ``experts.i.e.conv.weights1``, the gate a Dense."""
    _, pt, _, params0 = trainers
    state = from_jax_params(params0)
    model = pt.model.state_dict()
    assert set(state) == set(model)
    for k, v in state.items():
        assert tuple(v.shape) == tuple(model[k].shape), k
    n_jax = sum(np.asarray(a).size
                for a in jax.tree_util.tree_leaves(params0))
    assert sum(v.numel() for v in state.values()) == n_jax
    proc = params0["params"]["inner"]["processor_0"]
    assert proc["experts_1"]["w"]["kernel"].shape == (E, 1, 1, 20, 16)
    for e in range(E):
        np.testing.assert_array_equal(
            state[f"processor.0.experts.1.{e}.w.weight"].numpy(),
            np.transpose(proc["experts_1"]["w"]["kernel"][e], (3, 2, 0, 1)))
        np.testing.assert_array_equal(
            state[f"processor.0.experts.1.{e}.conv.weights2"].numpy(),
            proc["experts_1"]["conv"]["weights2"][e])
    np.testing.assert_array_equal(state["processor.0.gate.0.weight"].numpy(),
                                  proc["gate_0"]["kernel"].T)


def test_forward_and_rollout_match_jax(trainers):
    """The port's serving step and 3-step rollout against the JAX engine's,
    at the same weights; the serving block packs all of the experts'
    spectral weights."""
    _, _, _, params0 = trainers
    over = [f"--time_window={TW}", *SMALL]
    jeng = JaxEngine.from_config(JAX_CFG, pde=JaxPDE2D(**PDE_KW),
                                 overrides=over)
    jeng.params = jax.tree_util.tree_map(jnp.asarray, params0)
    teng = SurrogateEngine.from_config(PORT_CFG, pde=PDE2D(**PDE_KW),
                                       overrides=over, device="cpu")
    teng.load_jax_params(params0)
    assert sum(isinstance(m, MoEFNO) for m in teng.model.modules()) == 1
    # a rollout packs every expert's spectral weights once
    convs = [m for m in teng.model.modules() if isinstance(m, SpectralConvND)]
    assert len(convs) == 2 * E
    with packed_spectral_weights(teng.model):
        assert all(m.w_packed is not None for m in convs)
    u0, cond, sc = _inputs()
    with jax.default_matmul_precision("highest"):
        ref_roll = jeng.rollout(u0, n_steps=3, cond=cond, spatial_cond=sc)
    out = teng.step(u0, cond=cond, spatial_cond=sc)
    ref = ref_roll[:, :, :TW]
    assert out.shape == ref.shape == (B, 1, TW, NX, NX)
    assert _rel(out, ref) < REL_FWD
    roll = teng.rollout(u0, n_steps=3, cond=cond, spatial_cond=sc)
    assert roll.shape == ref_roll.shape
    nrmse = np.sqrt(np.mean((roll - ref_roll) ** 2) / np.mean(ref_roll ** 2))
    assert nrmse < NRMSE


def _jax_loss_and_grads(jt, batch):
    """The shipped step's loss rebuilt eagerly and jax.grad of it, at an
    injected depth and start steps."""
    _, u, x, cond, _, sc = (jnp.asarray(a) for a in batch)
    pde, mi = jt.data.pde, jt.model.model_interface
    apply = jax.jit(lambda p, d: jt.model.apply(
        p, d, cond=cond, bc=None, pos=x, t_cond=None, spatial_cond=sc))

    def loss_fn(p, data, labels):
        pred, _ = jax_process_step(pde, mi, apply(p, data), labels, None,
                                   get_bc=False, process_settings={})
        return jnp.sqrt(jt.criterion(pred, labels))

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))

    def run(depth, steps0):
        steps = jnp.asarray(steps0)
        data, labels = window(u, steps, TW, "both")
        for _ in range(depth):
            pred = apply(jt.params, data)
            labels_prev, steps = labels, steps + TW
            labels = window(u, steps, TW, "labels")
            data, _ = jax_process_step(pde, mi, pred, labels_prev, labels,
                                       process_settings={})
        return value_and_grad(jt.params, data, labels)

    return run


def test_train_steps_match_jax(trainers):
    """Loss and every parameter's gradient (each expert's and each gate's)
    at injected depths 0 and 1. A tensor whose gradient is below 1e-5 of
    the model's largest is held at that floor."""
    jt, pt, batch, params0 = trainers
    run = _jax_loss_and_grads(jt, batch)
    rng = np.random.default_rng(5)
    for depth in DEPTHS:
        pt.load_jax_params(params0)
        pt._build_optimizer()
        steps0 = rng.integers(TW, NT - TW - TW * depth + 1, B)
        with jax.default_matmul_precision("highest"):
            loss_ref, grads = run(depth, steps0)
        loss, _ = pt.train_step(
            tuple(torch.from_numpy(np.asarray(a)) for a in batch), 0, 0,
            unrolled=depth, steps0=torch.from_numpy(steps0))
        np.testing.assert_allclose(float(loss), float(loss_ref),
                                   rtol=REL_LOSS)
        ref = {k: v.numpy() for k, v in from_jax_params(
            jax.tree_util.tree_map(np.asarray, grads)).items()}
        got = {k: p.grad.numpy() for k, p in pt.model.named_parameters()}
        assert set(got) == set(ref)
        assert any(".gate." in k for k in got)
        floor = 1e-5 * max(np.abs(r).max() for r in ref.values())
        for k, g in got.items():
            scale = max(np.abs(ref[k]).max(), floor)
            assert np.abs(g - ref[k]).max() / scale < REL_GRAD, (depth, k)


def test_moe_e1_equals_plain_fno():
    """n_experts=1: the softmax gate is the constant 1, so each block is
    exactly an FNO layer with its GELU: the port's FNO processor's weights
    carried into the expert slots give the same bits, output and input
    gradient."""
    pde = PDE2D(**PDE_KW)
    kw = dict(num_spatial_dims=2, n_cond=4, hidden_features=16, fno_modes=4,
              hidden_blocks=2)
    torch.manual_seed(0)
    fno = FNO(**kw)
    moe = MoEFNO(pde=pde, n_experts=1, **kw)
    state = moe.state_dict()
    for k, v in fno.state_dict().items():
        state[re.sub(r"^fno_layers\.(\d+)\.", r"experts.\1.0.", k)] = v
    moe.load_state_dict(state)
    rng = np.random.default_rng(1)
    h = rng.standard_normal((B, 16, NX, NX)).astype(np.float32)
    vb = rng.standard_normal((B, 4, NX, NX)).astype(np.float32)
    cond = rng.standard_normal((B, 2)).astype(np.float32)
    outs, grads = [], []
    for m, extra in ((fno, {}), (moe, {"variables": torch.from_numpy(cond)})):
        x = torch.from_numpy(h).requires_grad_()
        y = m(x, variables_broadcast=torch.from_numpy(vb), **extra)
        y.square().sum().backward()
        outs.append(y.detach())
        grads.append(x.grad)
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(grads[0], grads[1])


def test_gate_without_conditioning_matches_jax():
    """A model without static conditioning: the gate reads the spatial
    mean of h. The JAX module's parameters (experts stacked) carried into
    the port's module: output and the input's gradient."""
    rng = np.random.default_rng(2)
    kw = dict(num_spatial_dims=2, n_cond=0, hidden_features=8, fno_modes=4,
              hidden_blocks=2, n_experts=3)
    h = rng.standard_normal((B, NX, NX, 8)).astype(np.float32)
    jm = JaxMoEFNO(**kw)
    params = jm.init(jax.random.PRNGKey(0), h)
    dy = rng.standard_normal(h.shape).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref, vjp = jax.vjp(lambda x: jm.apply(params, x), jnp.asarray(h))
        (ref_dh,) = vjp(jnp.asarray(dy))
    tm = MoEFNO(**kw)
    assert tm.n_gate_in == 8
    tm.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    x = torch.from_numpy(np.moveaxis(h, -1, 1).copy()).requires_grad_()
    out = tm(x)
    (out * torch.from_numpy(np.moveaxis(dy, -1, 1).copy())).sum().backward()
    assert _rel(np.moveaxis(out.detach().numpy(), 1, -1),
                np.asarray(ref)) < REL_FWD
    assert _rel(np.moveaxis(x.grad.numpy(), 1, -1),
                np.asarray(ref_dh)) < REL_GRAD


def test_module_in_bf16_matches_jax():
    """The module in bf16, the gate on the static conditioning and the
    experts' mixture summed in f32 and rounded once, against the JAX
    module in bf16 (its parameters carried over): output and the input's
    gradient at the bf16 bar, each side's f32 run the reference."""
    rng = np.random.default_rng(4)
    kw = dict(num_spatial_dims=2, n_cond=2, hidden_features=8, fno_modes=4,
              hidden_blocks=2, n_experts=3)
    h = rng.standard_normal((B, NX, NX, 8)).astype(np.float32)
    var = rng.random((B, 2)).astype(np.float32)
    vb = np.broadcast_to(var[:, None, None, :], (B, NX, NX, 2)).copy()
    dy = rng.standard_normal(h.shape).astype(np.float32)
    jm = JaxMoEFNO(**kw)
    params = jm.init(jax.random.PRNGKey(1), h, var, vb)
    tm = MoEFNO(pde=PDE2D(**PDE_KW), **kw)
    tm.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))

    def jax_run(dtype):
        jconfig.set_compute_dtype(dtype)
        try:
            x = jnp.asarray(h).astype(dtype or jnp.float32)
            with jax.default_matmul_precision("highest"):
                y, vjp = jax.vjp(lambda x: jm.apply(
                    params, x, jnp.asarray(var), jnp.asarray(vb)), x)
                (dx,) = vjp(jnp.asarray(dy).astype(y.dtype))
        finally:
            jconfig.set_compute_dtype(None)
        return (np.asarray(y.astype(jnp.float32)),
                np.asarray(dx.astype(jnp.float32)))

    def port_run(dtype):
        tdt = torch.bfloat16 if dtype else torch.float32
        x = torch.from_numpy(np.moveaxis(h, -1, 1).copy()).to(tdt)
        x.requires_grad_()
        with tconfig.compute_dtype_scope(dtype):
            y = tm(x, torch.from_numpy(var),
                   torch.from_numpy(np.moveaxis(vb, -1, 1).copy()))
            y.backward(torch.from_numpy(np.moveaxis(dy, -1, 1).copy())
                       .to(y.dtype))
        return (np.moveaxis(y.detach().float().numpy(), 1, -1),
                np.moveaxis(x.grad.float().numpy(), 1, -1), y.dtype)

    (j32, jdx32), (jbf, jdxbf) = jax_run(None), jax_run(jnp.bfloat16)
    out, dx, dt = port_run("bfloat16")
    assert dt == torch.bfloat16
    for port, ref_bf, ref32 in ((out, jbf, j32), (dx, jdxbf, jdx32)):
        scale = np.abs(ref32).max()
        bar = max(2 * np.abs(ref_bf - ref32).max() / scale, BF16_FLOOR)
        err = np.abs(port - ref_bf).max() / scale
        assert err <= bar, (err, bar)


def test_film_is_refused():
    with pytest.raises(AssertionError, match="FiLM"):
        MoEFNO(num_spatial_dims=2, n_cond=2, cond_mode="film")


@pytest.mark.parametrize("ep", [0, 1, 2])
def test_expert_parallel_above_one_is_refused(ep):
    """expert_parallel 0 and 1 are the single-device step; 2 splits the
    experts over the ranks of a (data, expert) grid
    (tests/test_torch_expert_parallel.py), and without data parallelism it
    is refused."""
    config = Namespace(expert_parallel=ep, data_parallel=False)
    if ep > 1:
        with pytest.raises(ValueError, match="data_parallel"):
            train_base.refuse_unported(config)
    else:
        train_base.refuse_unported(config)


def test_cli_trains_one_epoch_at_expert_parallel_1(data_dir):
    """One epoch through the port's CLI with --trainer.expert_parallel=1:
    finite train and validation losses."""
    argv = ["prog", "-C", PORT_CFG, "--device", "cpu",
            *_argv(data_dir, ["--trainer.num_epochs=1",
                              "--trainer.test_interval=1",
                              "--trainer.expert_parallel=1",
                              "--experiment_name=cli"])]
    trainer = train_cli.cli(argv)
    assert trainer.config.expert_parallel == 1
    with open(trainer.config.save_path + "_metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows] == [0]
    assert np.isfinite(rows[0]["train_loss"])
    assert np.isfinite(rows[0]["default - val loss"])
