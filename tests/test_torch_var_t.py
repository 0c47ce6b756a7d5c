"""The port's variable-time 1D path (``cfg_var1d_fno``, ``D.sim1d_var_t``)
against ``nps_tpu`` on the same seeded inputs: ragged storage (the port's
``RaggedMemmap`` and the plain-numpy ``mmap_ninja`` reader), the synthetic
generator byte for byte, the dataset, the batch sampler's batches and
depths, the min-crop and max-pad collates and loaders, the 1D spectral
conv and the 1D FNO model, the var-t train and evaluation steps, and one
CLI epoch on the CPU.

Sizes: 12 simulations of 20-50 frames on 32 points, time window 5, batch
4, an FNO of 2 blocks x 16 features with 4 modes (``cfg_var1d_fno`` at a
narrow width). Bars (ROADMAP "How a part is held"): forward max abs error
/ max |ref| < 1e-4; gradients max|d| / max|ref| < 5e-3 per tensor; losses
rtol 2e-3; JAX at precision "highest". Randomness is injected: the depth
through the JAX step's loader argument, the start steps recomputed from
its key (``nps_tpu/train/pushforward.py:438-440``) and handed to the port.
PyTorch runs on two threads, since the suite's workers share the cores.
"""

import os
import sys
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nps_tpu.models as jax_models
from nps_tpu.data import ragged as jax_ragged
from nps_tpu.data.pde1d_var_t import PDE1DVarTDataset as JaxDataset
from nps_tpu.data.pipeline import VariableTimeLoader as JaxLoader
from nps_tpu.data.samplers import VariableTimeBatchSampler as JaxSampler
from nps_tpu.data.synthetic import generate_var_t as jax_generate_var_t
from nps_tpu.models.activations import GELU as JaxGELU
from nps_tpu.ops.spectral import spectral_conv_nd as jax_spectral_conv_nd
from nps_tpu.train import AutoregressivePushforwardTrainer as JaxTrainer
from nps_tpu.train import build_criterion as jax_criterion
from nps_tpu.utils import collate as jax_collate
from nps_tpu.utils.process_output import process_step as jax_process_step
from nps_tpu_torch import models, train_cli
from nps_tpu_torch.common.interfaces import D
from nps_tpu_torch.compat.jax_weights import from_jax_params
from nps_tpu_torch.data import ragged
from nps_tpu_torch.data.pde1d_var_t import PDE1DVarTDataset
from nps_tpu_torch.data.pipeline import VariableTimeLoader
from nps_tpu_torch.data.samplers import VariableTimeBatchSampler
from nps_tpu_torch.data.synthetic import generate_var_t
from nps_tpu_torch.models.activations import GELU
from nps_tpu_torch.ops.spectral import spectral_conv_nd
from nps_tpu_torch.train import AutoregressivePushforwardTrainer
from nps_tpu_torch.train import build_criterion
from nps_tpu_torch.utils import collate

TW, NX, B = 5, 32, 4
T_MIN, T_MAX = 4 * TW, 10 * TW
REL_FWD, REL_GRAD, REL_LOSS = 1e-4, 5e-3, 2e-3
CFG = "nps_tpu_torch/configs/train/cfg_var1d_fno.py"


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("vart")
    generate_var_t(str(root / "sim1d"), n_sims=12, n_channels=2, nx=NX,
                   t_min=T_MIN, t_max=T_MAX, seed=7)
    return root


def _ds_kwargs(root):
    return dict(base_path=str(root), experiment="sim1d",
                conditioning="conditioning", split_file="split",
                name="var_t_test")


@pytest.fixture(scope="module")
def datasets(data_root):
    return (JaxDataset(**_ds_kwargs(data_root)),
            PDE1DVarTDataset(**_ds_kwargs(data_root)))


# ---------------------------------------------------------------- storage
def test_ragged_memmap_roundtrip_and_jax_reads_it(tmp_path):
    rng = np.random.default_rng(0)
    arrays = [rng.random((2, t, 8)).astype(np.float32) for t in (7, 13, 5)]
    rm = ragged.RaggedMemmap.save(str(tmp_path / "port"), arrays)
    jax_ragged.RaggedMemmap.save(str(tmp_path / "jax"), arrays)
    assert len(rm) == 3
    for name in ("data.npy", "offsets.npy", "shapes.npy"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    reopened = ragged.RaggedMemmap(str(tmp_path / "port"))
    by_jax = jax_ragged.open_ragged(str(tmp_path / "port"))
    for i, a in enumerate(arrays):
        np.testing.assert_array_equal(rm[i], a)
        np.testing.assert_array_equal(reopened[i], a)
        np.testing.assert_array_equal(by_jax[i], a)


def _write_ninja_array(dirname, arr, shape_as_text=True):
    """One array in mmap_ninja's convention: ``data.ninja`` and its
    ``dtype`` / ``shape`` / ``order`` sidecars."""
    os.makedirs(dirname, exist_ok=True)
    arr = np.asarray(arr)
    with open(os.path.join(dirname, "data.ninja"), "wb") as f:
        f.write(arr.tobytes())
    with open(os.path.join(dirname, "dtype.ninja"), "w") as f:
        f.write(arr.dtype.name)
    with open(os.path.join(dirname, "shape.ninja"), "wb") as f:
        f.write(("(" + ", ".join(str(s) for s in arr.shape) + ")").encode()
                if shape_as_text else np.asarray(arr.shape,
                                                 np.int64).tobytes())
    with open(os.path.join(dirname, "order.ninja"), "w") as f:
        f.write("C")


@pytest.mark.parametrize("variant", [
    dict(), dict(with_ends=True), dict(shapes_2d=True),
    dict(shape_as_text=False)])
def test_mmap_ninja_reader_matches_jax(tmp_path, variant):
    """A RaggedMmap directory in mmap_ninja's layout (the flat buffer, start
    offsets and flattened shapes as one-array subdirectories): the port's
    reader and ``open_ragged`` read what the JAX package's reads."""
    rng = np.random.default_rng(3)
    els = [rng.random((2, int(rng.integers(2, 9)), 4)).astype(np.float32)
           for _ in range(5)]
    d = str(tmp_path / "ninja")
    text = variant.get("shape_as_text", True)
    _write_ninja_array(d, np.concatenate([e.ravel() for e in els]), text)
    offsets = np.zeros(len(els) + 1, np.int64)
    np.cumsum([e.size for e in els], out=offsets[1:])
    _write_ninja_array(os.path.join(d, "starts"), offsets[:-1], text)
    if variant.get("with_ends"):
        _write_ninja_array(os.path.join(d, "ends"), offsets[1:], text)
    shapes = np.array([e.shape for e in els], np.int64)
    _write_ninja_array(os.path.join(d, "flattened_shapes"),
                       shapes if variant.get("shapes_2d") else shapes.ravel(),
                       text)
    ours, ref = ragged.MmapNinjaReader(d), jax_ragged.MmapNinjaReader(d)
    assert isinstance(ragged.open_ragged(d), ragged.MmapNinjaReader)
    assert len(ours) == len(ref) == len(els)
    for i, e in enumerate(els):
        np.testing.assert_array_equal(ours[i], ref[i])
        np.testing.assert_array_equal(ours[i], e)


def test_mmap_ninja_reader_refuses_what_jax_refuses(tmp_path):
    d = str(tmp_path / "bad")
    _write_ninja_array(d, np.zeros(10, np.float32))
    _write_ninja_array(os.path.join(d, "starts"), np.array([0, 4], np.int64))
    _write_ninja_array(os.path.join(d, "flattened_shapes"),
                       np.array([2, 2, 3, 3], np.int64))
    for reader in (ragged.MmapNinjaReader, jax_ragged.MmapNinjaReader):
        with pytest.raises(ValueError, match="extent"):
            reader(d)


def test_generate_var_t_writes_the_same_bytes(tmp_path):
    kw = dict(n_sims=9, n_channels=2, nx=NX, t_min=T_MIN, t_max=T_MAX,
              seed=11)
    generate_var_t(str(tmp_path / "port"), **kw)
    jax_generate_var_t(str(tmp_path / "jax"), **kw)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert sorted(p.relative_to(tmp_path / "port")
                  for p in (tmp_path / "port").rglob("*")
                  if p.is_file()) == files
    assert len(files) == 8
    for f in files:
        assert ((tmp_path / "port" / f).read_bytes()
                == (tmp_path / "jax" / f).read_bytes()), f


# ------------------------------------------------------- dataset, batches
def test_dataset_contract(datasets):
    jds, ds = datasets
    assert ds.data_interface == D.sim1d_var_t
    for attr in ("nt", "nx", "L", "dt", "tmin", "tmax", "n_cond_static",
                 "n_cond_dynamic"):
        assert getattr(ds.pde, attr) == getattr(jds.pde, attr), attr
    np.testing.assert_array_equal(ds.pde.x, jds.pde.x)
    for split in ("train", "valid", "test"):
        ours, ref = getattr(ds, split), getattr(jds, split)
        assert len(ours) == len(ref) > 0
        for i in range(len(ref)):
            for a, r in zip(ours[i], ref[i]):
                np.testing.assert_array_equal(a, r)
    u = ds.train[0][1]
    assert u.ndim == 3 and u.shape[0] == 2 and u.shape[2] == NX
    assert len({ds.train[i][1].shape[1] for i in range(len(ds.train))}) > 1


@pytest.mark.parametrize("with_replacement", [True, False])
def test_sampler_batches_and_depths_match_jax(datasets, with_replacement):
    jds, ds = datasets
    kw = dict(batch_size=B, time_window=TW, max_unrolling=2,
              with_replacement=with_replacement, seed=3)
    ours, ref = VariableTimeBatchSampler(ds.train, **kw), \
        JaxSampler(jds.train, **kw)
    assert len(ours) == len(ref)
    np.testing.assert_array_equal(ours.lengths, ref.lengths)
    depths = set()
    for _ in range(3):
        got, want = list(ours), list(ref)
        assert [list(map(int, b)) for b in got] == \
            [list(map(int, b)) for b in want]
        for i in range(len(want)):
            assert ours.get_t_batch(i) == ref.get_t_batch(i)
            depths.add(ours.get_t_batch(i))
    assert len(depths) > 1


def test_collates_match_jax(datasets):
    """min-crop with the starts drawn once per batch element, max-pad to a
    time-window multiple, the 5-tuple ``collate_data`` (max mode) and the
    validity mask."""
    _, ds = datasets
    els = [ds.train[i] for i in range(5)]
    us = [e[1] for e in els]
    lengths = [u.shape[1] for u in us]
    starts = collate.min_crop_starts(lengths, TW,
                                     rng=np.random.default_rng(5))
    np.testing.assert_array_equal(
        starts, jax_collate.min_crop_starts(lengths, TW,
                                            rng=np.random.default_rng(5)))
    for mode in ("min", "max"):
        kw = dict(starts=starts) if mode == "min" else {}
        got = collate.collate_batch_sim(1, mode, TW)(us, **kw)
        want = jax_collate.collate_batch_sim(1, mode, TW)(us, **kw)
        assert got.shape[2] % TW == 0
        np.testing.assert_array_equal(got, want)
    five = [e[:5] for e in els]
    for a, r in zip(collate.collate_data(mode="max", tw=TW)(five),
                    jax_collate.collate_data(mode="max", tw=TW)(five)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(r))
    padded = collate.collate_batch_sim(1, "max", TW)(us)
    mask = collate.create_data_mask(padded, lengths)
    np.testing.assert_array_equal(
        mask, jax_collate.create_data_mask(padded, lengths))
    assert mask.sum() == sum(u.size for u in us)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_loaders_match_jax(datasets, mode):
    jds, ds = datasets
    kw = dict(batch_size=B, time_window=TW, max_unrolling=1,
              with_replacement=mode == "min", seed=3)
    ours = VariableTimeLoader(ds.train, VariableTimeBatchSampler(
        ds.train, **kw), mode=mode, time_window=TW, seed=5)
    ref = JaxLoader(jds.train, JaxSampler(jds.train, **kw), mode=mode,
                    time_window=TW, seed=5, process_index=0,
                    process_count=1)
    assert len(ours) == len(ref)
    for _ in range(2):
        got, want = list(ours), list(ref)
        assert len(got) == len(want) > 0
        for bg, bw in zip(got, want):
            assert len(bg) == len(bw) == 7
            assert bg[1].shape[2] % TW == 0
            for a, r in zip(bg, bw):
                assert a.dtype == np.asarray(r).dtype
                np.testing.assert_array_equal(a, np.asarray(r))
    # two processes (P9b item 1): the ranks' slices of every batch make up
    # the one-process batch, trimmed to a multiple of the process count;
    # a process index outside the world is refused
    one = list(VariableTimeLoader(ds.train, VariableTimeBatchSampler(
        ds.train, **kw), mode=mode, time_window=TW, seed=5))
    ranks = [list(VariableTimeLoader(
        ds.train, VariableTimeBatchSampler(ds.train, **kw), mode=mode,
        time_window=TW, seed=5, process_index=i, process_count=2))
        for i in range(2)]
    assert len(ranks[0]) == len(ranks[1]) == len(one)
    for whole, *parts in zip(one, *ranks):
        n = len(whole[1]) - len(whole[1]) % 2
        if n < len(whole[1]):
            continue   # an odd batch's extent is the trimmed batch's
        for k in (1, 2, 3, 6):
            np.testing.assert_array_equal(
                np.concatenate([p[k] for p in parts]), whole[k][:n])
    with pytest.raises(ValueError, match="not one of the 2 processes"):
        VariableTimeLoader(ds.train, VariableTimeBatchSampler(ds.train, **kw),
                           process_index=2, process_count=2)


# ------------------------------------------------------------ the 1D op
@pytest.mark.parametrize("film_mode", [None, 0, 1])
def test_spectral_conv_1d_matches_jax(film_mode):
    """Forward within 1e-4 of max |ref|; the gradients of <out, dy> with
    respect to x, the weights and the FiLM scales (jax.grad) within 5e-3.
    n1 = 32 with 8 modes, as cfg_var1d_fno."""
    rng = np.random.default_rng(1)
    b, ci, co, n1, m1 = 3, 6, 5, NX, 8
    x = rng.standard_normal((b, ci, n1)).astype(np.float32)
    w = (rng.random((2, ci, co, m1)) / (ci * co)).astype(np.float32)
    film = (rng.standard_normal((b, co, m1)).astype(np.float32)
            if film_mode is not None else None)
    dy = rng.standard_normal((b, co, n1)).astype(np.float32)

    def jax_fn(x, w, film):
        out = jax_spectral_conv_nd(jnp.moveaxis(x, 1, -1), [w], (m1,),
                                   film=film, film_mode=film_mode or 0,
                                   num_spatial_dims=1)
        return jnp.moveaxis(out, -1, 1)

    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax_fn(x, w, film))
        argnums = (0, 1, 2) if film is not None else (0, 1)
        jgrads = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * dy),
                          argnums=argnums)(x, w, film)
    xt, wt = (torch.tensor(a, requires_grad=True) for a in (x, w))
    ft = torch.tensor(film, requires_grad=True) if film is not None else None
    out = spectral_conv_nd(xt, [wt], (m1,), film=ft,
                           film_mode=film_mode or 0, num_spatial_dims=1)
    assert out.dtype == torch.float32 and out.shape == (b, co, n1)
    assert _rel(out.detach().numpy(), ref) < REL_FWD
    (out * torch.from_numpy(dy)).sum().backward()
    got = [xt.grad, wt.grad] + ([ft.grad] if ft is not None else [])
    for g, r in zip(got, jgrads):
        assert _rel(g.numpy(), np.asarray(r)) < REL_GRAD


def _model_kwargs(pde, hidden=16, blocks=2, modes=4):
    return dict(num_c=2, num_spatial_dims=1, time_window=TW,
                encoder="enc_grid.ElementWise", processor="FNO",
                fno_modes=modes, hidden_blocks=blocks,
                hidden_features=hidden, padding_mode="circular",
                decoder="dec_grid.TimeConvDense", dec_delta_mode="per_step",
                pde=pde)


@pytest.mark.parametrize("cond_mode", ["concat", "film"])
def test_fno_1d_model_forward_matches_jax(datasets, cond_mode):
    """The 1D EncProcDec + FNO (concat or FiLM conditioning) with JAX's
    weights transplanted: one apply within 1e-4."""
    jds, ds = datasets
    rng = np.random.default_rng(2)
    u = rng.random((B, 2, TW, NX)).astype(np.float32)
    cond = rng.random((B, 2)).astype(np.float32)
    pos = np.broadcast_to(ds.pde.x[None], (B, NX)).astype(np.float32)
    jm = jax_models.EncProcDec(activation=JaxGELU(), cond_mode=cond_mode,
                               **_model_kwargs(jds.pde))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), u, cond=cond, pos=pos)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(jm.apply)(params, u, cond=cond, pos=pos))
    pm = models.EncProcDec(activation=GELU(), cond_mode=cond_mode,
                           **_model_kwargs(ds.pde))
    pm.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                              params)))
    with torch.no_grad():
        out = pm(torch.from_numpy(u), cond=torch.from_numpy(cond),
                 pos=torch.from_numpy(pos))
    assert out.shape == ref.shape == (B, 2, TW, NX)
    assert _rel(out.numpy(), ref) < REL_FWD


# ------------------------------------------------------ train and evaluate
def _trainer_kwargs(tag, tmp):
    return dict(save_path=str(tmp / tag), time_window=TW,
                base_resolution=(T_MAX, NX), super_resolution=(T_MAX, NX),
                device="cpu", batch_size=B, nr_gt_steps=1, nw=0,
                num_epochs=2, lr_step_interval=1, unrolling=1,
                print_interval=10, test_interval=2, process_settings={})


@pytest.fixture(scope="module")
def trainers(datasets, tmp_path_factory):
    from nps_tpu.utils.seed import set_seed as jax_set_seed
    from nps_tpu_torch.utils.seed import set_seed

    # each package's samplers and start keys read its own global seed,
    # which a config an earlier test in this process parsed in one package
    # alone leaves unequal: both start from a fresh process's seed
    jax_set_seed(0)
    set_seed(0)
    jds, ds = datasets
    tmp = tmp_path_factory.mktemp("vart_out")
    jt = JaxTrainer(
        model=jax_models.EncProcDec(activation=JaxGELU(),
                                    **_model_kwargs(jds.pde)),
        data=jds, criterion=jax_criterion(object="nn.MSELoss",
                                          reduction="sum"),
        optimizer=dict(object="optim.Adam", lr=1e-3), lr_scheduler=None,
        **_trainer_kwargs("jax", tmp))
    with jax.default_matmul_precision("highest"):
        jt.ensure_initialized(jt.get_dataloaders()[0])
    params0 = jax.tree_util.tree_map(np.asarray, jt.params)
    pt = AutoregressivePushforwardTrainer(
        model=models.EncProcDec(activation=GELU(), **_model_kwargs(ds.pde)),
        data=ds, criterion=build_criterion(object="nn.MSELoss",
                                           reduction="sum"),
        optimizer=dict(object="optim.Adam", lr=1e-3), lr_scheduler=None,
        **_trainer_kwargs("port", tmp))
    pt.load_jax_params(params0)
    pt.ensure_initialized()
    return jt, pt, params0


def _reset(jt, pt, params0):
    jt.params = jax.tree_util.tree_map(jnp.asarray, params0)
    jt.opt_state = jt.tx.init(jt.params)
    pt.load_jax_params(params0)
    pt._build_optimizer()


def _steps0(epoch, batch_idx, t_res, depth):
    from nps_tpu.utils.seed import get_seed

    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(get_seed()), epoch), batch_idx)
    return np.array(jax.random.randint(
        key, (B,), TW, t_res - TW - TW * depth + 1, dtype=jnp.int32))


def _torch(batch):
    return tuple(torch.from_numpy(np.asarray(a)) for a in batch)


def test_trainer_loaders_match_jax(trainers):
    """The trainers' own (train, valid, test) loaders: min-crop for
    training, max-pad for evaluation, identical batches and depths."""
    jt, pt, _ = trainers
    for ours, ref in zip(pt.get_dataloaders(), jt.get_dataloaders()):
        assert ours.mode == ref.mode
        got, want = list(ours), list(ref)
        assert len(got) == len(want) > 0
        for bg, bw in zip(got, want):
            for a, r in zip(bg, bw):
                np.testing.assert_array_equal(a, np.asarray(r))
        for i in range(len(want)):
            assert ours.batch_sampler.get_t_batch(i) == \
                ref.batch_sampler.get_t_batch(i)


@pytest.mark.parametrize("depth", [0, 1])
def test_var_t_train_step_matches_jax(trainers, depth):
    """One min-cropped batch at the depth its sampler would give: the loss
    (rtol 2e-3) against the JAX trainer's step, and every gradient against
    jax.grad of the same loss rebuilt eagerly (5e-3)."""
    from nps_tpu.train.pushforward import window

    jt, pt, params0 = trainers
    _reset(jt, pt, params0)
    batch = next(iter(jt.get_dataloaders()[0]))
    t_res = batch[1].shape[2]
    steps0 = _steps0(0, 0, t_res, depth)
    loader = Namespace(batch_sampler=Namespace(get_t_batch=lambda i: depth))
    _, u, x, cond, _, _, _ = (jnp.asarray(a) for a in batch)
    pde, mi = jt.data.pde, jt.model.model_interface

    def loss_fn(p):
        def apply(d):
            return jt.model.apply(p, d, cond=cond, bc=None, pos=x,
                                  t_cond=None, spatial_cond=None)

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
        loss_shipped, _ = jt.train_step(tuple(jnp.asarray(a) for a in batch),
                                        0, 0, loader=loader)
    np.testing.assert_allclose(float(loss_shipped), float(loss_ref),
                               rtol=1e-4)
    loss, _ = pt.train_step(_torch(batch), 0, 0, loader=loader,
                            steps0=torch.from_numpy(steps0))
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=REL_LOSS)
    ref = {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, grads)).items()}
    got = {k: p.grad.numpy() for k, p in pt.model.named_parameters()}
    assert set(got) == set(ref)
    for k, g in got.items():
        assert _rel(g, ref[k]) < REL_GRAD, k


def test_var_t_train_steps_follow_jax_through_an_epoch(trainers):
    """Every batch of one train epoch, each at its sampler's depth, both
    trainers stepping Adam: the losses stay within rtol 2e-3."""
    jt, pt, params0 = trainers
    _reset(jt, pt, params0)
    jl, pl = jt.get_dataloaders()[0], pt.get_dataloaders()[0]
    n = 0
    for i, (jb, pb) in enumerate(zip(jl, pl)):
        depth = jl.batch_sampler.get_t_batch(i)
        assert pl.batch_sampler.get_t_batch(i) == depth
        with jax.default_matmul_precision("highest"):
            loss_ref, _ = jt.train_step(tuple(jnp.asarray(a) for a in jb),
                                        1, i, loader=jl)
        steps0 = _steps0(1, i, jb[1].shape[2], depth)
        loss, _ = pt.train_step(_torch(pb), 1, i, loader=pl,
                                steps0=torch.from_numpy(steps0))
        np.testing.assert_allclose(float(loss), float(loss_ref),
                                   rtol=REL_LOSS)
        n += 1
    assert n == len(jl) > 1


def test_masked_eval_matches_jax_and_ignores_padding(trainers):
    """A max-padded validation batch: the port's metrics against the JAX
    trainer's (rtol 2e-3), and padded frames count for nothing: the same
    batch padded by one more window of garbage gives the same sum (the
    metric divides by the padded rollout length, as upstream)."""
    jt, pt, params0 = trainers
    _reset(jt, pt, params0)
    batch = list(next(iter(jt.get_dataloaders()[1])))
    with jax.default_matmul_precision("highest"):
        loss_ref, info_ref = jt.test_step(
            tuple(jnp.asarray(a) for a in batch), 0)
    loss1, info = pt.test_step(_torch(batch), 0)
    assert set(info) == set(info_ref)
    for k, v in info_ref.items():
        np.testing.assert_allclose(info[k], v, rtol=REL_LOSS, atol=1e-12,
                                   err_msg=k)
    np.testing.assert_allclose(loss1, loss_ref, rtol=REL_LOSS)

    u = np.asarray(batch[1])
    assert (np.asarray(batch[6]) < u.shape[2]).any()
    pad = np.concatenate([u, np.full(u.shape[:2] + (TW,) + u.shape[3:], 7.7,
                                     u.dtype)], axis=2)
    loss2, _ = pt.test_step(_torch([*batch[:1], pad, *batch[2:]]), 0)

    def n_t(t_res):
        return TW * len(range(TW, t_res - TW + 1, TW))

    s1, s2 = loss1 * n_t(u.shape[2]), loss2 * n_t(pad.shape[2])
    assert np.isclose(s1, s2, rtol=1e-4), (s1, s2)


def test_cli_epoch_of_cfg_var1d_fno_on_cpu(tmp_path):
    """One CLI epoch of the shipped config at a narrow width on a generated
    ragged split: finite losses, a metrics line, the saved models."""
    generate_var_t(str(tmp_path / "data" / "var1d"), n_sims=12,
                   n_channels=2, nx=NX, t_min=T_MIN, t_max=T_MAX, seed=1)
    argv = ["prog", "-C", CFG, "--device", "cpu",
            f"--dataset.base_path={tmp_path / 'data'}",
            "--model.hidden_features=16", "--model.fno_modes=4",
            "--trainer.num_epochs=1", "--trainer.test_interval=1",
            "--trainer.print_interval=1", f"--experiment_path={tmp_path}",
            "--experiment_name=run"]
    saved = sys.argv
    try:
        trainer = train_cli.cli(argv)
    finally:
        sys.argv = saved
    assert trainer.config.variable_time
    assert trainer.device.type == "cpu"
    save = trainer.config.save_path
    with open(save + "_metrics.jsonl") as f:
        rows = f.read().splitlines()
    assert len(rows) == 1
    for suffix in ("_default.pt", "_final.pt", "_checkpoint.pt"):
        assert os.path.exists(save + suffix), suffix
    import json

    row = json.loads(rows[0])
    assert np.isfinite(row["train_loss"])
    assert np.isfinite(row["default - val loss"])
