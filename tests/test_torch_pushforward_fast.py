"""``--trainer.pushforward_fast``: cheaper numerics inside the no-grad
pushforward applies only (the port's counterpart of
``tests/test_pushforward_fast.py``). There the exact GELU, the U-FNO's own
and the fused GroupNorm+GELU's, becomes the tanh form; the JAX package
also takes bf16 GroupNorm statistics there for bf16 inputs, where the port
keeps f32 ones.

The U-FNO twophase config at a small size (1 block x 8 features, 4 modes,
24x16 grid, time window 5, 21 frames), both trainers built by their own
CLI's ``get_config_static`` on the same split, JAX weights carried into the
port. The JAX step is rebuilt eagerly with the pushforward applies traced
inside ``fast_forward_scope``, as the shipped step's scan body is.

- depth 0 (no pushforward apply): the flag is a strict no-op, loss and
  parameters after the step bit for bit;
- depth 2 in f32: loss rtol 2e-3, every gradient max|d| / max|ref| < 5e-3
  against JAX with the flag (ROADMAP "How a part is held");
- depth 2 in bf16: |port - JAX| / |JAX_f32| of the loss <= max(2 d_jax,
  8e-3), d_jax JAX's own bf16-vs-f32 deviation (``test_torch_dtype.py``);
- the scope is active in the pushforward applies alone (not the graded
  apply, ``test_step`` or the engine) and never leaks, an exception
  included.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nps_tpu.configs.parse import parse_args as jax_parse_args
from nps_tpu.data.pipeline import HostDataLoader as JaxHostDataLoader
from nps_tpu.models import config as jconfig
from nps_tpu.train.pushforward import window
from nps_tpu.train_cli import get_config_static as jax_build
from nps_tpu.utils.process_output import process_step as jax_process_step
from nps_tpu_torch import train_cli
from nps_tpu_torch.compat.jax_weights import from_jax_params
from nps_tpu_torch.configs.parse import parse_args as port_parse_args
from nps_tpu_torch.data.synthetic import generate
from nps_tpu_torch.inference import SurrogateEngine
from nps_tpu_torch.models import config as tconfig
from nps_tpu_torch.pde import PDE2D

JAX_CFG = "nps_tpu/configs/train/cfg_twophase_ufno.py"
PORT_CFG = "nps_tpu_torch/configs/train/cfg_twophase_ufno.py"
NT, NX1, NX2, TW, B, DEPTH = 21, 24, 16, 5, 2, 2
REL_LOSS, REL_GRAD, BF16_FLOOR = 2e-3, 5e-3, 8e-3
FAST = "--trainer.pushforward_fast=true"


def _parse(fn, cfg, argv):
    saved = sys.argv
    try:
        sys.argv = ["prog", *argv]
        return fn(cfg)
    finally:
        sys.argv = saved


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _f32_after():
    """Both packages back at f32 after each test (the switch is global)."""
    yield
    jconfig.set_compute_dtype(None)
    tconfig.set_compute_dtype(None)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("pf_fast")
    generate(str(root / "data" / "twophase"), n_sims=8, n_channels=1, nt=NT,
             nx1=NX1, nx2=NX2, seed=5)
    return root


def _argv(data_dir, extra=()):
    return [f"--base_resolution=[{NT},{NX1},{NX2}]",
            f"--super_resolution=[{NT},{NX1},{NX2}]",
            f"--time_window={TW}", f"--batch_size={B}",
            f"--dataset.base_path={data_dir / 'data'}",
            "--dataset.c_filter=[0]", "--model.hidden_features=8",
            "--model.hidden_blocks=1", "--model.fno_modes=4",
            f"--experiment_path={data_dir / 'out'}",
            "--experiment_name=run", *extra]


def _port(data_dir, params0, *extra):
    pt = train_cli.get_config_static(
        _parse(port_parse_args, PORT_CFG, _argv(data_dir, extra)),
        device="cpu")[4]
    pt.load_jax_params(params0)
    pt.set_optimizer(dict(object="optim.Adam", lr=1e-4))
    return pt


@pytest.fixture(scope="module")
def setup(data_dir):
    """The JAX trainer, its weights, one batch and start steps for a
    depth-2 step."""
    jt = jax_build(_parse(jax_parse_args, JAX_CFG, _argv(data_dir)))[5]
    loader = JaxHostDataLoader(jt.data.train, B, seed=0, process_index=0,
                               process_count=1)
    batch = next(iter(loader))
    with jax.default_matmul_precision("highest"):
        jt.init_params(batch)
    params0 = jax.tree_util.tree_map(np.asarray, jt.params)
    steps0 = np.random.default_rng(5).integers(TW, NT - TW - TW * DEPTH + 1,
                                               B)
    return jt, params0, batch, steps0


def _jax_step(jt, batch, steps0, fast, dtype=None):
    """(loss, grads) of the JAX step at DEPTH, its pushforward applies
    traced inside fast_forward_scope(fast), under ``dtype``."""
    jconfig.set_compute_dtype(dtype)
    _, u, x, cond, _, sc = (jnp.asarray(a) for a in batch)
    pde, mi = jt.data.pde, jt.model.model_interface

    def apply_in(scope):
        def f(p, d):
            with jconfig.fast_forward_scope(scope):
                return jt.model.apply(p, d, cond=cond, bc=None, pos=x,
                                      t_cond=None, spatial_cond=sc)
        return jax.jit(f)

    push, graded = apply_in(fast), apply_in(False)

    def loss_fn(p, data, labels):
        pred, _ = jax_process_step(pde, mi, graded(p, data), labels, None,
                                   get_bc=False, process_settings={})
        return jnp.sqrt(jt.criterion(pred, labels))

    with jax.default_matmul_precision("highest"):
        steps = jnp.asarray(steps0)
        data, labels = window(u, steps, TW, "both")
        for _ in range(DEPTH):
            pred = push(jt.params, data)
            labels_prev, steps = labels, steps + TW
            labels = window(u, steps, TW, "labels")
            data, _ = jax_process_step(pde, mi, pred, labels_prev, labels,
                                       process_settings={})
        loss, grads = jax.value_and_grad(loss_fn)(jt.params, data, labels)
    return float(loss), grads


def _port_step(pt, batch, steps0, depth):
    loss, _ = pt.train_step(
        tuple(torch.from_numpy(np.asarray(a)) for a in batch), 0, 0,
        unrolled=depth, steps0=torch.from_numpy(np.asarray(steps0)))
    return float(loss)


def test_depth0_flag_is_a_no_op(setup, data_dir):
    """No pushforward apply at depth 0: loss and parameters after the Adam
    step are the same bits with the flag on and off."""
    _, params0, batch, steps0 = setup
    off, on = _port(data_dir, params0), _port(data_dir, params0, FAST)
    assert on.config.pushforward_fast and not off.config.pushforward_fast
    assert _port_step(on, batch, steps0, 0) == _port_step(off, batch, steps0,
                                                          0)
    for (k, a), (_, b) in zip(off.model.state_dict().items(),
                              on.model.state_dict().items()):
        assert torch.equal(a, b), k


def test_depth2_f32_matches_jax_with_the_flag(setup, data_dir):
    """At depth 2 in f32 the port with the flag against JAX with the flag:
    loss and every gradient. The flag changes the loss on both sides."""
    jt, params0, batch, steps0 = setup
    loss_ref, grads = _jax_step(jt, batch, steps0, True)
    loss_plain, _ = _jax_step(jt, batch, steps0, False)
    pt = _port(data_dir, params0, FAST)
    loss = _port_step(pt, batch, steps0, DEPTH)
    np.testing.assert_allclose(loss, loss_ref, rtol=REL_LOSS)
    assert loss_ref != loss_plain
    assert loss != _port_step(_port(data_dir, params0), batch, steps0, DEPTH)
    ref = {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, grads)).items()}
    got = {k: p.grad.numpy() for k, p in pt.model.named_parameters()}
    assert set(got) == set(ref)
    floor = 1e-5 * max(np.abs(r).max() for r in ref.values())
    for k, g in got.items():
        scale = max(np.abs(ref[k]).max(), floor)
        assert np.abs(g - ref[k]).max() / scale < REL_GRAD, k


def test_depth2_bf16_matches_jax_with_the_flag(setup, data_dir):
    """At depth 2 in bf16 (JAX: bf16 GroupNorm statistics in the
    pushforward; the port: f32 ones): the loss at the bf16 bar."""
    jt, params0, batch, steps0 = setup
    loss32, _ = _jax_step(jt, batch, steps0, True)
    loss16, _ = _jax_step(jt, batch, steps0, True, "bfloat16")
    pt = _port(data_dir, params0, FAST, "--trainer.compute_dtype=bfloat16")
    loss = _port_step(pt, batch, steps0, DEPTH)
    d_jax = abs(loss16 - loss32) / abs(loss32)
    err = abs(loss - loss16) / abs(loss32)
    assert np.isfinite(loss)
    assert err <= max(2 * d_jax, BF16_FLOOR), (err, d_jax)


def _record_scope(pt):
    """Wrap the trainer's model apply to record fast_forward_active() at
    each call."""
    seen, apply = [], pt._apply

    def recording(*args, **kwargs):
        seen.append(tconfig.fast_forward_active())
        return apply(*args, **kwargs)

    pt._apply = recording
    return seen


def test_only_the_pushforward_applies_see_the_scope(setup, data_dir):
    """The two pushforward applies of a depth-2 step run inside the scope;
    the graded apply, the evaluation's applies and the engine's rollout do
    not; nothing is left active after them."""
    _, params0, batch, steps0 = setup
    pt = _port(data_dir, params0, FAST)
    seen = _record_scope(pt)
    _port_step(pt, batch, steps0, DEPTH)
    assert seen == [True, True, False]
    seen.clear()
    pt.test_step(tuple(torch.from_numpy(np.asarray(a)) for a in batch), 0)
    assert seen and not any(seen)
    assert not tconfig.fast_forward_active()

    pde = PDE2D(tmin=0, tmax=10, nt=NT, L1=1.0, L2=0.7, nx1=NX1, nx2=NX2,
                x=None, name="twophase", n_cond_static=2, n_cond_spatial=2)
    eng = SurrogateEngine.from_config(
        PORT_CFG, pde=pde, device="cpu",
        overrides=[f"--time_window={TW}", "--model.hidden_features=8",
                   "--model.hidden_blocks=1", "--model.fno_modes=4", FAST])
    seen_eng, forward = [], eng.model.forward

    def recording(*args, **kwargs):
        seen_eng.append(tconfig.fast_forward_active())
        return forward(*args, **kwargs)

    eng.model.forward = recording
    u, cond, sc = (np.asarray(batch[1])[:, :, :TW], np.asarray(batch[3]),
                   np.asarray(batch[5]))
    eng.rollout(u, 2, cond=cond, spatial_cond=sc)
    assert seen_eng == [False, False]


def test_scope_restores_on_exception(setup, data_dir):
    """The scope restores the caller's value when the block raises: at the
    switch itself and inside a train step whose pushforward apply fails."""
    with pytest.raises(RuntimeError, match="boom"):
        with tconfig.fast_forward_scope(True):
            assert tconfig.fast_forward_active()
            raise RuntimeError("boom")
    assert not tconfig.fast_forward_active()

    _, params0, batch, steps0 = setup
    pt = _port(data_dir, params0, FAST)

    def failing(*args, **kwargs):
        assert tconfig.fast_forward_active()
        raise RuntimeError("boom")

    pt._apply = failing
    with pytest.raises(RuntimeError, match="boom"):
        _port_step(pt, batch, steps0, DEPTH)
    assert not tconfig.fast_forward_active()

