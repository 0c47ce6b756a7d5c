"""Gradient accumulation in the port (``--trainer.grad_accum=N``, the JAX
trainer's ``optax.MultiSteps``) and ``data_parallel`` in one process, at the
small Dilated ResNet of ``tests/test_grad_accum.py`` (1 block x 8 features,
16x16 grid, time window 5, batch 4) on the same synthetic split.

Pins: the parameters and Adam's state change only at every N-th mini-step;
the scheduler's rate reaches the optimizer that steps; two boundaries of a
``grad_accum=2`` run match the JAX ``MultiSteps`` run on the same weights
and batches (losses rtol 2e-3, parameters after each boundary max|d| /
max|ref| < 5e-3; JAX keeps a running mean where the port sums and scales
by 1/N, which differ in rounding only); the partial sum and its counter
carry over an epoch's end and through a save and resume. Randomness is
injected: depth 0 (``unrolling=0``) and the JAX step's start indices,
recomputed from its key and handed to the port. PyTorch runs on two
threads, since the suite's workers share the cores.
"""

from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nps_tpu.models as jax_models
from nps_tpu.data.pde2d import PDE2DDataset as JaxPDE2DDataset
from nps_tpu.data.pipeline import device_put_batch
from nps_tpu.data.synthetic import generate
from nps_tpu.models.activations import GELU as JaxGELU
from nps_tpu.train import AutoregressivePushforwardTrainer as JaxTrainer
from nps_tpu.train import build_criterion as jax_criterion
from nps_tpu_torch import models
from nps_tpu_torch.compat.jax_weights import from_jax_params
from nps_tpu_torch.data.pde2d import PDE2DDataset
from nps_tpu_torch.models.activations import GELU
from nps_tpu_torch.train import AutoregressivePushforwardTrainer
from nps_tpu_torch.train import base as train_base
from nps_tpu_torch.train import build_criterion
from nps_tpu_torch.train import optim as optim_lib

TW, NT, NX, B = 5, 21, 16, 4
REL_LOSS, REL_PARAM = 2e-3, 5e-3


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    d = tmp_path_factory.mktemp("gds") / "twophase"
    generate(str(d), n_sims=12, n_channels=2, nt=NT, nx1=NX, nx2=NX,
             seed=10)
    return d.parent


def _ds_kwargs(root):
    return dict(base_path=str(root), experiment="twophase",
                data_format="memmap", data_file="snapshots",
                conditioning="conditioning",
                spatial_conditioning="spatial_conditioning",
                split_file="split", c_filter=[0], name="twophase")


def _config(tmp_path, tag, **extra):
    return dict(save_path=str(tmp_path / tag), time_window=TW,
                base_resolution=(NT, NX, NX), super_resolution=(NT, NX, NX),
                batch_size=B, nr_gt_steps=1, nw=0, num_epochs=1,
                lr_step_interval=1, unrolling=0, print_interval=1,
                test_interval=2, process_settings={}, **extra)


def _model_kwargs(pde):
    return dict(num_c=1, num_spatial_dims=2, time_window=TW,
                encoder="enc_grid.ElementWise", processor="DilatedResnet",
                kernel_size=3, hidden_blocks=1, hidden_features=8,
                padding_mode="circular", decoder="dec_grid.TimeConvDense",
                dec_delta_mode="per_step", pde=pde)


def _port(root, tmp_path, tag="pt", **extra):
    ds = PDE2DDataset(**_ds_kwargs(root))
    model = models.EncProcDec(activation=GELU(), **_model_kwargs(ds.pde))
    return AutoregressivePushforwardTrainer(
        model=model, data=ds,
        criterion=build_criterion(object="nn.MSELoss", reduction="sum"),
        optimizer=dict(object="optim.Adam", lr=1e-3),
        lr_scheduler=dict(object="optim.lr_scheduler.MultiStepLR",
                          milestones=[1], gamma=0.5),
        device="cpu", **_config(tmp_path, tag, **extra))


def _params(trainer):
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


def _moved(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def _batch(trainer, i=0):
    loader = trainer.get_dataloaders()[0]
    for j, batch in enumerate(loader):
        if j == i:
            return tuple(torch.from_numpy(a) for a in batch)
    raise IndexError(i)


def _steps0(epoch, batch_idx, t_res=NT, depth=0):
    """The JAX step's start indices (``pushforward.py:438-440``)."""
    from nps_tpu.utils.seed import get_seed

    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(get_seed()), epoch), batch_idx)
    return np.array(jax.random.randint(
        key, (B,), TW, t_res - TW - TW * depth + 1, dtype=jnp.int32))


@pytest.mark.parametrize("every", [2, 3])
def test_updates_apply_at_accumulation_boundary(data_root, tmp_path, every):
    """Parameters and Adam's moments and step count stay put until the
    every-th mini-step; the reported loss is each mini-batch's own."""
    tr = _port(data_root, tmp_path, grad_accum=every)
    tr.ensure_initialized()
    assert isinstance(tr.optimizer, optim_lib.MultiSteps)
    batch = _batch(tr)
    p0 = _params(tr)
    for i in range(every - 1):
        loss, _ = tr.train_step(batch, 0, i)
        assert torch.isfinite(loss)
        assert _moved(p0, _params(tr)) == 0.0
        assert not tr.optimizer.inner.state
        assert tr.optimizer.mini_step == i + 1
    tr.train_step(batch, 0, every - 1)
    assert _moved(p0, _params(tr)) > 0
    assert tr.optimizer.mini_step == 0
    steps = {float(s["step"]) for s in tr.optimizer.inner.state.values()}
    assert steps == {1.0}


def test_boundary_steps_the_mean_gradient(data_root, tmp_path):
    """At the boundary Adam steps once on the mean of the two mini-steps'
    gradients: the update of one plain Adam step given that mean."""
    acc = _port(data_root, tmp_path, "acc", grad_accum=2)
    acc.ensure_initialized()
    p0 = _params(acc)
    grads = _port(data_root, tmp_path, "grads")
    grads.ensure_initialized()
    grads.model.load_state_dict(p0)
    grads.set_optimizer((torch.optim.SGD(grads.model.parameters(), lr=0.0),
                         0.0))
    seen = []
    for i in range(2):
        batch = _batch(acc, i)
        steps0 = torch.from_numpy(_steps0(0, i))
        acc.train_step(batch, 0, i, unrolled=0, steps0=steps0)
        grads.train_step(batch, 0, i, unrolled=0, steps0=steps0)
        seen.append({n: q.grad.clone()
                     for n, q in grads.model.named_parameters()})
    ref = _port(data_root, tmp_path, "ref")
    ref.ensure_initialized()
    ref.model.load_state_dict(p0)
    for n, q in ref.model.named_parameters():
        q.grad = (seen[0][n] + seen[1][n]) / 2
    ref.optimizer.step()
    got = _params(acc)
    for k, v in _params(ref).items():
        torch.testing.assert_close(got[k], v)
    assert _moved(p0, got) > 0


def test_lr_scheduler_reaches_inner_state(data_root, tmp_path):
    tr = _port(data_root, tmp_path, grad_accum=2)
    tr.ensure_initialized()
    optim_lib.set_learning_rate(tr.optimizer, 123.0)
    assert tr.optimizer.inner.param_groups[0]["lr"] == 123.0
    tr.max_train_batches = 0
    loader = tr.get_dataloaders()[0]
    tr.train_one_epoch(loader, 0)   # the scheduler steps past milestone 1
    assert tr.lr_scheduler.lr == pytest.approx(5e-4)
    assert tr.optimizer.inner.param_groups[0]["lr"] == pytest.approx(5e-4)


def _jax_trainer(root, tmp_path):
    ds = JaxPDE2DDataset(**_ds_kwargs(root))
    model = jax_models.EncProcDec(activation=JaxGELU(),
                                  **_model_kwargs(ds.pde))
    return JaxTrainer(
        model=model, data=ds,
        criterion=jax_criterion(object="nn.MSELoss", reduction="sum"),
        optimizer=dict(object="optim.Adam", lr=1e-3), lr_scheduler=None,
        device="cpu", **_config(tmp_path, "jax", grad_accum=2))


def test_two_boundaries_match_jax_multisteps(data_root, tmp_path):
    """Four mini-steps (two boundaries) of the JAX ``MultiSteps`` run and
    the port's on the same weights and batches."""
    jt = _jax_trainer(data_root, tmp_path)
    jloader = jt.get_dataloaders()[0]
    jt.ensure_initialized(jloader)
    pt = _port(data_root, tmp_path, grad_accum=2)
    pt.load_jax_params(jax.tree_util.tree_map(np.asarray, jt.params))
    pt.ensure_initialized()
    host = [b for _, b in zip(range(2), iter(jloader))]
    before = _params(pt)
    for i in range(4):
        batch = host[i % 2]
        with jax.default_matmul_precision("highest"):
            loss_ref, _ = jt.train_step(device_put_batch(batch, None), 0, i,
                                        loader=None)
        loss, _ = pt.train_step(tuple(torch.from_numpy(a) for a in batch),
                                0, i, unrolled=0,
                                steps0=torch.from_numpy(_steps0(0, i)))
        np.testing.assert_allclose(float(loss), float(loss_ref),
                                   rtol=REL_LOSS)
        got = _params(pt)
        if i % 2 == 0:
            assert _moved(before, got) == 0.0
            continue
        ref = from_jax_params(jax.tree_util.tree_map(np.asarray, jt.params))
        for k, v in got.items():
            r = ref[k].numpy()
            assert (np.abs(v.numpy() - r).max()
                    / max(np.abs(r).max(), 1e-30)) < REL_PARAM, k
        assert _moved(before, got) > 0
        before = got


def test_accumulation_survives_epoch_and_resume(data_root, tmp_path):
    """The train split's 10 samples make 3 batches of 4, 4, 2: after one
    epoch at grad_accum=2 one mini-step is pending. It carries into the
    next epoch, and through a checkpoint: a resumed trainer holds the same
    counter and partial sum, and its next mini-step (the boundary) gives
    the same parameters as the trainer that never stopped."""
    tr = _port(data_root, tmp_path, "run", grad_accum=2)
    tr.ensure_initialized()
    loader = tr.get_dataloaders()[0]
    assert len(loader) == 3
    tr.train_one_epoch(loader, 0)
    assert tr.optimizer.mini_step == 1
    partial = {n: p.grad.clone() for n, p in tr.model.named_parameters()}
    tr.save_checkpoint(1, train_loader=loader)

    resumed = _port(data_root, tmp_path, "run", grad_accum=2, resume=True)
    resumed.ensure_initialized()
    assert resumed.maybe_resume(train_loader=resumed.get_dataloaders()[0])
    assert resumed.start_epoch == 1
    assert resumed.optimizer.mini_step == 1
    for n, p in resumed.model.named_parameters():
        torch.testing.assert_close(p.grad, partial[n], rtol=0, atol=0)

    batch = _batch(tr)
    steps0 = torch.from_numpy(_steps0(1, 0))
    p0 = _params(tr)
    for t in (tr, resumed):
        t.train_step(batch, 1, 0, unrolled=0, steps0=steps0)
        assert t.optimizer.mini_step == 0
    assert _moved(p0, _params(tr)) > 0
    for k, v in _params(tr).items():
        torch.testing.assert_close(_params(resumed)[k], v, rtol=0, atol=0)


def test_data_parallel_in_one_process(data_root, tmp_path, monkeypatch):
    """``data_parallel=True`` in a world of one process trains as the
    single-device step. A world of two is this rank's share of the global
    batch (P9b items 1-2; tests/test_torch_distributed.py trains such
    worlds); refused still: a launcher's ``WORLD_SIZE`` of two with no
    process group and a world of two without ``data_parallel``. In that
    world tensor parallelism (P9b item 4) is accepted, and refused with
    ``zero1`` or beside a second regime."""
    tr = _port(data_root, tmp_path, data_parallel=True)
    tr.ensure_initialized()
    ref = _port(data_root, tmp_path, "ref")
    ref.ensure_initialized()
    ref.model.load_state_dict(tr.model.state_dict())
    batch = _batch(tr)
    steps0 = torch.from_numpy(_steps0(0, 0))
    loss, _ = tr.train_step(batch, 0, 0, unrolled=0, steps0=steps0)
    loss_ref, _ = ref.train_step(batch, 0, 0, unrolled=0, steps0=steps0)
    assert float(loss) == float(loss_ref)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="init_distributed"):
        _port(data_root, tmp_path, data_parallel=True)
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 0)
    train_base.refuse_unported(Namespace(data_parallel=True))
    two = _port(data_root, tmp_path, data_parallel=True)
    assert (two.data_parallel, two.rank, two.world) == (True, 0, 2)
    with pytest.raises(ValueError, match="data_parallel"):
        train_base.refuse_unported(Namespace(data_parallel=False))
    train_base.refuse_unported(Namespace(data_parallel=True,
                                         tensor_parallel=2))
    with pytest.raises(ValueError, match="zero1"):
        train_base.refuse_unported(Namespace(data_parallel=True,
                                             tensor_parallel=2, zero1=True))
    with pytest.raises(NotImplementedError, match="P9b item 4"):
        train_base.refuse_unported(Namespace(data_parallel=True,
                                             tensor_parallel=2,
                                             spatial_parallel=2))


def test_cli_epoch_with_grad_accum_flag(data_root, tmp_path):
    """``--trainer.grad_accum=2`` through the training CLI on a config that
    carries the key (the twophase configs, as in the JAX package): the
    optimizer accumulates, and the epoch's 3 batches leave one mini-step
    pending at its end."""
    from nps_tpu_torch import train_cli

    argv = ["prog", "-C", "nps_tpu_torch/configs/train/cfg_twophase_drn.py",
            "--device", "cpu", f"--base_resolution=[{NT},{NX},{NX}]",
            f"--super_resolution=[{NT},{NX},{NX}]", f"--time_window={TW}",
            f"--batch_size={B}", f"--dataset.base_path={data_root}",
            "--dataset.c_filter=[0]", "--model.hidden_features=8",
            "--model.hidden_blocks=1", "--trainer.num_epochs=1",
            "--trainer.test_interval=1", "--trainer.grad_accum=2",
            f"--experiment_path={tmp_path}", "--experiment_name=run"]
    trainer = train_cli.cli(argv)
    assert isinstance(trainer.optimizer, optim_lib.MultiSteps)
    assert trainer.optimizer.every == 2
    assert trainer.optimizer.mini_step == 1
    state = torch.load(trainer.config.save_path + "_checkpoint.pt",
                       weights_only=False)["optimizer"]
    assert state["mini_step"] == 1
    assert any(g is not None for g in state["acc_grads"])
