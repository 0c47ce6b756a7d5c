"""The port's training path against ``nps_tpu``'s: the U-FNO twophase config
at a small size (2 blocks x 8 features, 4 modes, 24x16 grid, time window
5, 51 frames), both trainers built by their own CLI's
``get_config_static`` from their own configs on the same synthetic split,
JAX weights transplanted into the port.

The evaluation cases use the first 21 frames (3 bundled steps) and the CLI
case a split of 21-frame simulations, to keep JAX's compiles short; the
train-step cases need 51 frames for depth 8. PyTorch runs on two threads
here, since the suite's workers share the machine's cores.

Randomness is injected, not drawn: the JAX trainer's depth through a
monkeypatched ``py_random.choice``, its start steps recomputed from its key
(``pushforward.py:333-335,736-738``) and handed to the port. Bars (ROADMAP
"How a part is held"): losses rtol 2e-3; gradients (``jax.grad`` of the
JAX loss) max|d| / max|ref| < 5e-3 per parameter; parameters after three
Adam steps max|d| / max|ref| < 2e-3; rollout nRMSE < 1e-3. JAX runs at
precision "highest"; the two sides sum in other orders.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nps_tpu.train.pushforward as jax_pushforward
from nps_tpu.configs.parse import parse_args as jax_parse_args
from nps_tpu.data.pipeline import HostDataLoader as JaxHostDataLoader
from nps_tpu.train.optim import MultiStepLR as JaxMultiStepLR
from nps_tpu.train_cli import get_config_static as jax_build
from nps_tpu.utils.process_output import process_step as jax_process_step
from nps_tpu_torch import train_cli
from nps_tpu_torch.compat.jax_weights import from_jax_params
from nps_tpu_torch.configs.parse import parse_args as port_parse_args
from nps_tpu_torch.data.synthetic import generate

JAX_CFG = "nps_tpu/configs/train/cfg_twophase_ufno.py"
PORT_CFG = "nps_tpu_torch/configs/train/cfg_twophase_ufno.py"
NT, NX1, NX2, TW, B = 51, 24, 16, 5, 2
NT_EVAL = 21  # frames of the evaluation and CLI cases
EPOCH, BATCH_IDX = 200, 3  # epoch // 25 = 8: the ramp admits depths 0..8
REL_LOSS, REL_GRAD, REL_PARAM, NRMSE = 2e-3, 5e-3, 2e-3, 1e-3


def _overrides(data, out, extra=(), nt=NT):
    return [f"--base_resolution=[{nt},{NX1},{NX2}]",
            f"--super_resolution=[{nt},{NX1},{NX2}]",
            f"--time_window={TW}", f"--batch_size={B}",
            f"--dataset.base_path={data}", "--dataset.c_filter=[0]",
            "--model.hidden_features=8", "--model.hidden_blocks=2",
            "--model.fno_modes=4", f"--experiment_path={out}",
            "--experiment_name=run", *extra]


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


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    generate(str(root / "data" / "twophase"), n_sims=8, n_channels=1, nt=NT,
             nx1=NX1, nx2=NX2, seed=2)
    generate(str(root / "short" / "twophase"), n_sims=8, n_channels=1,
             nt=NT_EVAL, nx1=NX1, nx2=NX2, seed=2)
    return root


@pytest.fixture(scope="module")
def trainers(data_dir):
    argv = _overrides(data_dir / "data", data_dir / "out")
    jt = jax_build(_parse(jax_parse_args, JAX_CFG, argv))[5]
    pt = train_cli.get_config_static(_parse(port_parse_args, PORT_CFG, argv),
                                     device="cpu")[4]
    loader = JaxHostDataLoader(jt.data.train, B, seed=0, process_index=0,
                               process_count=1)
    batch = next(iter(loader))
    with jax.default_matmul_precision("highest"):
        jt.init_params(batch)
    jt.set_optimizer(dict(object="optim.Adam", lr=1e-4))
    params0 = jax.tree_util.tree_map(np.asarray, jt.params)
    pt.load_jax_params(params0)
    pt.set_optimizer(dict(object="optim.Adam", lr=1e-4))
    return jt, pt, batch, params0


def _reset(jt, pt, params0):
    jt.params = jax.tree_util.tree_map(jnp.asarray, params0)
    jt.opt_state = jt.tx.init(jt.params)
    pt.load_jax_params(params0)
    pt._build_optimizer()


def _steps0(jt, depth, epoch=EPOCH, batch_idx=BATCH_IDX):
    from nps_tpu.utils.seed import get_seed

    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(get_seed()), epoch), batch_idx)
    return np.array(jax.random.randint(
        key, (B,), TW, NT - TW - TW * depth + 1, dtype=jnp.int32))


@pytest.fixture(scope="module")
def jax_loss_and_grads(trainers):
    """The shipped step's loss rebuilt eagerly (the pattern of
    tests/test_trainer.py), and jax.grad of it; compiled once."""
    from nps_tpu.train.pushforward import window

    jt, _, batch, _ = trainers
    _, u, x, cond, _, sc = (jnp.asarray(a) for a in batch)
    pde, mi = jt.data.pde, jt.model.model_interface
    apply = jax.jit(lambda p, d: jt.model.apply(
        p, d, cond=cond, bc=None, pos=x, t_cond=None, spatial_cond=sc))

    def loss_fn(p, data, labels):
        pred, _ = jax_process_step(pde, mi, apply(p, data), labels, None,
                                   get_bc=False, process_settings={})
        return jnp.sqrt(jt.criterion(pred, labels))

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))

    def run(params, depth, steps0):
        steps = jnp.asarray(steps0)
        data, labels = window(u, steps, TW, "both")
        for _ in range(depth):
            pred = apply(params, data)
            labels_prev, steps = labels, steps + TW
            labels = window(u, steps, TW, "labels")
            data, _ = jax_process_step(pde, mi, pred, labels_prev, labels,
                                       process_settings={})
        return value_and_grad(params, data, labels)

    return run


def _port_batch(batch):
    return tuple(torch.from_numpy(np.asarray(a)) for a in batch)


def _short(batch):
    """The batch cut to its first NT_EVAL frames."""
    u_base, u, *rest = batch
    return (u_base, np.ascontiguousarray(u[:, :, :NT_EVAL]), *rest)


def _rel(a, ref):
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("depth", range(9))
def test_train_step_matches_jax(trainers, jax_loss_and_grads, monkeypatch,
                                depth):
    """Loss and every parameter's gradient at an injected depth. A tensor
    whose gradient is below 1e-5 of the model's largest (zero in exact
    arithmetic, f32 noise on both sides: the last up block's shortcut bias)
    is held at that floor."""
    jt, pt, batch, params0 = trainers
    _reset(jt, pt, params0)
    steps0 = _steps0(jt, depth)
    with jax.default_matmul_precision("highest"):
        loss_ref, grads = jax_loss_and_grads(jt.params, depth, steps0)
        monkeypatch.setattr(jax_pushforward.py_random, "choice",
                            lambda seq: depth)
        loss_shipped, _ = jt.train_step(tuple(jnp.asarray(a) for a in batch),
                                        EPOCH, BATCH_IDX, loader=None)
    np.testing.assert_allclose(float(loss_shipped), float(loss_ref),
                               rtol=1e-4)

    loss, _ = pt.train_step(_port_batch(batch), EPOCH, BATCH_IDX,
                            unrolled=depth, steps0=steps0)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=REL_LOSS)
    ref = {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, grads)).items()}
    got = {k: p.grad.numpy() for k, p in pt.model.named_parameters()}
    assert set(got) == set(ref)
    floor = 1e-5 * max(np.abs(r).max() for r in ref.values())
    for k, g in got.items():
        scale = max(np.abs(ref[k]).max(), floor)
        assert np.abs(g - ref[k]).max() / scale < REL_GRAD, k


def test_parameters_after_three_adam_steps_match_jax(trainers,
                                                     jax_loss_and_grads,
                                                     monkeypatch):
    """Three depth-1 steps of both packages' Adam from the same weights,
    both optimizers fed the same gradients: at each step jax.grad of the
    JAX loss at JAX's parameters (the rebuilt shipped step), which the
    port's own step's gradients must first match at the gradient bar, then
    go to optax's update and, in place of the port's, to its Adam. Why the
    same gradients: Adam's first steps move each parameter by about lr x
    sign(g), so where a gradient is near zero the two packages' last-bit
    differences flip its sign and move the parameter by up to 2 lr, which
    for a small parameter is more than REL_PARAM of it (2.26e-3 measured
    on an AMD EPYC CPU): a test of the gradients' noise, not of Adam. With
    the same gradients it holds Adam (moments, bias correction, lr) and
    the loop, the parameters after three steps within REL_PARAM."""
    import optax

    jt, pt, batch, params0 = trainers
    _reset(jt, pt, params0)
    inner = pt.optimizer.step
    fed = {}

    def step_with_jax_grads():
        got = {k: p.grad.numpy() for k, p in pt.model.named_parameters()}
        ref = fed["grads"]
        floor = 1e-5 * max(np.abs(r).max() for r in ref.values())
        for k, g in got.items():
            scale = max(np.abs(ref[k]).max(), floor)
            assert np.abs(g - ref[k]).max() / scale < REL_GRAD, k
        with torch.no_grad():
            for k, p in pt.model.named_parameters():
                p.grad = torch.from_numpy(ref[k]).clone()
        inner()

    monkeypatch.setattr(pt.optimizer, "step", step_with_jax_grads)
    for i in range(3):
        steps0 = _steps0(jt, 1, batch_idx=i)
        with jax.default_matmul_precision("highest"):
            _, grads = jax_loss_and_grads(jt.params, 1, steps0)
        fed["grads"] = {k: v.numpy() for k, v in from_jax_params(
            jax.tree_util.tree_map(np.asarray, grads)).items()}
        updates, jt.opt_state = jt.tx.update(grads, jt.opt_state, jt.params)
        jt.params = optax.apply_updates(jt.params, updates)
        pt.train_step(_port_batch(batch), EPOCH, i, unrolled=1,
                      steps0=steps0)
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, jt.params))
    for k, p in pt.model.state_dict().items():
        assert _rel(p.numpy(), ref[k].numpy()) < REL_PARAM, k


@pytest.mark.parametrize("depth", [0, 1])
def test_train_step_from_bf16_device_cache_matches_jax(trainers, depth):
    """A train step from a ``device_cache_dtype="bfloat16"`` cache
    (``nps_tpu/train/base.py:535-546``): both packages' device caches give
    the same bf16 batch; the port's step, which widens it to the f32
    compute dtype, against jax.grad of the JAX loss on the cached values in
    f32 at an injected depth: loss rtol 2e-3, every gradient < 5e-3. (The
    JAX trainer's shipped step refuses a bf16 batch under f32 compute: its
    pushforward ``fori_loop`` carry turns from bf16 to f32.)"""
    from nps_tpu.data.pipeline import DeviceCacheLoader as JaxCache
    from nps_tpu.train.pushforward import window
    from nps_tpu_torch.data.pipeline import DeviceCacheLoader

    jt, pt, _, params0 = trainers
    _reset(jt, pt, params0)
    jbatch = next(iter(JaxCache(jt.data.train, B, seed=0,
                                cache_dtype="bfloat16")))
    batch = next(iter(DeviceCacheLoader(pt.data.train, B, seed=0,
                                        cache_dtype="bfloat16")))
    assert batch[1].dtype == torch.bfloat16
    for a, ref in zip(batch, jbatch):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(ref, np.float32))
    steps0 = _steps0(jt, depth)
    # the cache's values in the compute dtype, f32, as the port widens them
    wide = tuple(jnp.asarray(a, jnp.float32) if jnp.issubdtype(
        jnp.asarray(a).dtype, jnp.floating) else jnp.asarray(a)
        for a in jbatch)
    _, u, x, cond, _, sc = wide
    pde, mi = jt.data.pde, jt.model.model_interface

    def loss_fn(p):
        def apply(d):
            return jt.model.apply(p, d, cond=cond, bc=None, pos=x,
                                  t_cond=None, spatial_cond=sc)

        steps = jnp.asarray(steps0)
        data, labels = window(u, steps, TW, "both")
        for _ in range(depth):
            pred = jax.lax.stop_gradient(apply(data))
            labels_prev, steps = labels, steps + TW
            labels = window(u, steps, TW, "labels")
            data, _ = jax_process_step(pde, mi, pred, labels_prev, labels,
                                       process_settings={})
        pred, _ = jax_process_step(pde, mi, apply(data), labels, None,
                                   get_bc=False, process_settings={})
        return jnp.sqrt(jt.criterion(pred, labels))

    with jax.default_matmul_precision("highest"):
        loss_ref, grads = jax.jit(jax.value_and_grad(loss_fn))(jt.params)
    loss, _ = pt.train_step(batch, EPOCH, BATCH_IDX, unrolled=depth,
                            steps0=torch.from_numpy(steps0))
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=REL_LOSS)
    ref = {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, grads)).items()}
    got = {k: p.grad.numpy() for k, p in pt.model.named_parameters()}
    assert set(got) == set(ref)
    floor = 1e-5 * max(np.abs(r).max() for r in ref.values())
    for k, g in got.items():
        scale = max(np.abs(ref[k]).max(), floor)
        assert np.abs(g - ref[k]).max() / scale < REL_GRAD, k


def test_test_step_matches_jax(trainers):
    jt, pt, batch, params0 = trainers
    _reset(jt, pt, params0)
    batch = _short(batch)
    with jax.default_matmul_precision("highest"):
        loss_ref, info_ref = jt.test_step(
            tuple(jnp.asarray(a) for a in batch), 0)
    loss, info = pt.test_step(_port_batch(batch), 0)
    assert set(info) == set(info_ref)
    assert any(k.startswith("Step ") for k in info)
    for k, v in info_ref.items():
        np.testing.assert_allclose(info[k], v, rtol=REL_LOSS, atol=1e-12,
                                   err_msg=k)
    np.testing.assert_allclose(loss, loss_ref, rtol=REL_LOSS)


def test_simulate_matches_jax(trainers):
    jt, pt, batch, params0 = trainers
    _reset(jt, pt, params0)
    _, u, x, cond, _, sc = _short(batch)
    kw = dict(compute_loss=True, include_data=True, nr_gt_steps=1,
              t_res=NT_EVAL, spatial_conditioning=sc)
    with jax.default_matmul_precision("highest"):
        losses_ref, (gt_ref, ref) = jt.simulate(u, cond, x, **kw)
    losses, (gt, out) = pt.simulate(u, cond, x, **kw)
    n_steps = len(range(TW, NT_EVAL - TW + 1, TW))
    assert out.shape == ref.shape == (B, 1, TW + n_steps * TW, NX1, NX2)
    np.testing.assert_array_equal(gt, gt_ref)
    nrmse = np.sqrt(np.mean((out - ref) ** 2) / np.mean(ref ** 2))
    assert nrmse < NRMSE
    np.testing.assert_allclose(losses, losses_ref, rtol=REL_LOSS)


@pytest.mark.parametrize("interval", [1, 2])
def test_multistep_lr_steps_every_interval(trainers, interval):
    """The scheduler steps after every ``lr_step_interval``-th epoch and the
    optimizer takes its rate, as ``nps_tpu/train/base.py:772-776``."""
    _, pt, _, params0 = trainers
    pt.load_jax_params(params0)
    sched = dict(object="optim.lr_scheduler.MultiStepLR",
                 milestones=[1, 2], gamma=0.4)
    pt.set_optimizer(dict(object="optim.Adam", lr=1e-4))
    pt.set_lr_scheduler(sched)
    ref = JaxMultiStepLR(1e-4, [1, 2], 0.4)
    saved = (pt.config.lr_step_interval, pt.max_train_batches)
    pt.config.lr_step_interval, pt.max_train_batches = interval, 0
    loader = pt.get_dataloaders()[0]
    try:
        for epoch in range(4):
            pt.train_one_epoch(loader, epoch)
            if (epoch + 1) % interval == 0:
                ref.step()
            assert pt.lr_scheduler.epoch == ref.epoch
            assert pt.optimizer.param_groups[0]["lr"] == pytest.approx(ref.lr)
    finally:
        pt.config.lr_step_interval, pt.max_train_batches = saved


def _cli(data_dir, extra):
    argv = ["prog", "-C", PORT_CFG, "--device", "cpu",
            *_overrides(data_dir / "short", data_dir / "cli",
                        ["--trainer.test_interval=1",
                         "--trainer.print_interval=1",
                         "--optimizer.lr=0.001", *extra], nt=NT_EVAL)]
    return train_cli.cli(argv)


def test_cli_trains_saves_and_resumes_on_cpu(data_dir):
    """Two epochs through the CLI: finite train losses, a validation loss
    that falls from the untrained model's (an eval-only run of the same
    seed) epoch by epoch, a metrics line per epoch, the best, final and
    checkpoint files, then a resume at the checkpoint's epoch. (The train
    loss itself is no signal here: each batch draws new start windows.)"""
    import os
    import pickle

    untrained = _cli(data_dir, ["--trainer.eval_only=true"])
    with open(untrained.config.save_path + "_eval_summary.pickle", "rb") as f:
        loss0 = pickle.load(f)["default/valid"]["loss"]

    trainer = _cli(data_dir, ["--trainer.num_epochs=2"])
    save = trainer.config.save_path
    with open(save + "_metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) for r in rows)
    val = [r["default - val loss"] for r in rows]
    assert loss0 > val[0] > val[1]
    for suffix in ("_default.pt", "_final.pt", "_checkpoint.pt",
                   "_train_summary.pickle"):
        assert os.path.exists(save + suffix), suffix
    assert torch.load(save + "_checkpoint.pt", weights_only=False)["epoch"] == 2

    resumed = _cli(data_dir, ["--trainer.num_epochs=3",
                              "--trainer.resume=true"])
    assert resumed.start_epoch == 2
    with open(save + "_metrics.jsonl") as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1, 2]
