"""The ns512 U-FNO (``cfg_ns512_ufno``) in the port against ``nps_tpu``, at
a small width: 2 blocks x 16 features, ``ch_mults`` [1, 1, 1], 4 modes, a
32 x 32 grid, tanh-approximate GELU, batch 2, with the static and spatial
conditioning of the port's synthetic generator. Both engines are built from
their own ``cfg_ns512_ufno.py`` with the same overrides, the JAX weights
carried into the port.

Also: the state dict mapped to the JAX tree and back; the engine built
from the port's config over a synthetic 32 x 32
split read through ``PDE2DDataset``; the bf16 model exported and reloaded;
the U-FNO's ``remat`` fields; training: both trainers built by their own
CLI's ``get_config_static`` from the config (bf16, remat with
``save_conv_outputs``) at 1 block x 8 features, one train step at injected
depths 0 and 1 against ``nps_tpu`` in bf16 (loss and every gradient), and
a CLI epoch in bf16; and which spectral kernel variant, forward and
backward, the ns512 and twophase shapes take.

Bars: f32, forward max|d| / max|ref| < 1e-4 and 3-step rollout nRMSE <
1e-3 (ROADMAP "How a part is held"). bf16 (see ``test_torch_dtype.py``):
with d_jax the JAX bf16 result's deviation from JAX f32 relative to
max|JAX f32| (for the rollout, nRMSE in place of the max), the port in
bf16 against JAX in bf16 is within max(2 d_jax, 8e-3); for a train step
the same bar holds the loss, and each parameter's gradient in RMS terms
(scale: the RMS of JAX f32's gradient, or 1e-4 of the largest such RMS
where it is smaller). The artifact against the engine: rtol 1e-5, atol 1e-6.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nps_tpu.compat import convert_state_dict
from nps_tpu.compat.torch_weights import assert_params_match_structure
from nps_tpu.configs.parse import parse_args as jax_parse_args
from nps_tpu.data.pipeline import HostDataLoader as JaxHostDataLoader
from nps_tpu.inference import SurrogateEngine as JaxEngine
from nps_tpu.models import config as jconfig
from nps_tpu.pde import PDE2D as JaxPDE2D
from nps_tpu.train.pushforward import window
from nps_tpu.train_cli import get_config_static as jax_build
from nps_tpu.utils.process_output import process_step as jax_process_step
from nps_tpu_torch import train_cli
from nps_tpu_torch.compat.jax_weights import from_jax_params
from nps_tpu_torch.configs.parse import parse_args as port_parse_args
from nps_tpu_torch.data.pde2d import PDE2DDataset
from nps_tpu_torch.data.synthetic import generate
from nps_tpu_torch.inference import SurrogateEngine, load_exported
from nps_tpu_torch.models import config as tconfig
from nps_tpu_torch.models.ufno import UFNO
from nps_tpu_torch.ops import spectral as tsp
from nps_tpu_torch.pde import PDE2D

JAX_CFG = "nps_tpu/configs/train/cfg_ns512_ufno.py"
PORT_CFG = "nps_tpu_torch/configs/train/cfg_ns512_ufno.py"
NT, N, TW, B, STEPS = 21, 32, 5, 2, 3
OVERRIDES = ["--model.hidden_features=16", "--model.hidden_blocks=2",
             "--model.fno_modes=4", f"--time_window={TW}",
             f"--base_resolution=[{NT},{N},{N}]",
             f"--super_resolution=[{NT},{N},{N}]", f"--batch_size={B}"]
PDE_KW = dict(tmin=0, tmax=1, nt=NT, L1=1.0, L2=1.0, nx1=N, nx2=N, x=None,
              name="ns512", n_cond_static=2, n_cond_spatial=2)
REL_FWD, NRMSE, BF16_FLOOR = 1e-4, 1e-3, 8e-3
BF16 = "bfloat16"


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
    jconfig.set_compute_dtype(None)
    tconfig.set_compute_dtype(None)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    u0 = (0.1 + 0.8 * rng.random((B, 1, TW, N, N))).astype(np.float32)
    cond = rng.random((B, 2)).astype(np.float32)
    sc = (rng.random((B, 2, N, N)) > 0.8).astype(np.float32)
    return u0, cond, sc


def _nrmse(a, ref):
    return float(np.sqrt(np.mean((a - ref) ** 2) / np.mean(ref ** 2)))


@pytest.fixture(scope="module")
def runs():
    """3-step rollouts of both packages in f32 and bf16 from one seed
    window, the same weights: {(package, dtype): frames}, and the port's
    bf16 engine."""
    u0, cond, sc = _inputs()
    out, params = {}, None
    try:
        for dtype in (None, BF16):
            # the config's compute dtype is bf16: f32 is asked for by name
            jeng = JaxEngine.from_config(JAX_CFG, pde=JaxPDE2D(**PDE_KW),
                                         overrides=OVERRIDES,
                                         compute_dtype=dtype or "float32")
            with jax.default_matmul_precision("highest"):
                if params is None:
                    jeng.init_params(u0, cond=cond, spatial_cond=sc, seed=0)
                    params = jeng.params
                jeng.params = params
                out["jax", dtype] = jeng.rollout(u0, STEPS, cond=cond,
                                                 spatial_cond=sc)
    finally:
        jconfig.set_compute_dtype(None)
    host = out["params"] = jax.tree_util.tree_map(np.asarray, params)
    engines = {}
    for dtype in (None, BF16):
        eng = SurrogateEngine.from_config(PORT_CFG, pde=PDE2D(**PDE_KW),
                                          overrides=OVERRIDES, device="cpu",
                                          compute_dtype=dtype or "float32")
        eng.load_jax_params(host)
        engines[dtype] = eng
        out["port_step", dtype] = eng.step(u0, cond=cond, spatial_cond=sc)
        out["port", dtype] = eng.rollout(u0, STEPS, cond=cond,
                                         spatial_cond=sc)
    return out, engines


def test_config_parses_to_the_jax_dict():
    """The port's config is the JAX config's, key for key (activation
    objects by class name)."""
    def parse(fn, cfg):
        saved = sys.argv
        try:
            sys.argv = ["prog"]
            args = fn(cfg)
        finally:
            sys.argv = saved
        return {g: {k: (type(v).__name__ if hasattr(v, "_parse_override")
                        else v) for k, v in args[g].items()}
                if isinstance(args[g], dict) else args[g] for g in args}

    assert parse(port_parse_args, PORT_CFG) == parse(jax_parse_args, JAX_CFG)


@pytest.mark.parametrize("dtype", [None, BF16])
def test_forward_matches_jax(runs, dtype):
    """One serving step against the first bundled step of the JAX
    rollout."""
    out, _ = runs
    ref32 = out["jax", None][:, :, :TW]
    step = out["port_step", dtype]
    assert step.shape == (B, 1, TW, N, N) and step.dtype == np.float32
    scale = np.abs(ref32).max()
    if dtype is None:
        assert np.abs(step - ref32).max() / scale < REL_FWD
    else:
        ref = out["jax", BF16][:, :, :TW]
        d_jax = np.abs(ref - ref32).max() / scale
        err = np.abs(step - ref).max() / scale
        assert err <= max(2 * d_jax, BF16_FLOOR), (err, d_jax)


@pytest.mark.parametrize("dtype", [None, BF16])
def test_rollout_matches_jax(runs, dtype):
    out, _ = runs
    roll, ref32 = out["port", dtype], out["jax", None]
    assert roll.shape == ref32.shape == (B, 1, STEPS * TW, N, N)
    assert np.isfinite(roll).all()
    if dtype is None:
        assert _nrmse(roll, ref32) < NRMSE
    else:
        d_jax = _nrmse(out["jax", BF16], ref32)
        err = _nrmse(roll, out["jax", BF16])
        assert err <= max(2 * d_jax, BF16_FLOOR), (err, d_jax)


def test_state_dict_round_trip(runs):
    """The 3-level U-FNO with tanh GELU maps both ways:
    ``convert_state_dict`` of the port's state_dict is the JAX tree the
    port loaded, leaf for leaf."""
    out, engines = runs
    conv = {"params": {"inner": convert_state_dict(
        engines[None].model.state_dict())["params"]}}
    target = jax.tree_util.tree_map(np.asarray, out["params"])
    assert_params_match_structure(conv, target)
    for (p, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(conv)[0],
            jax.tree_util.tree_flatten_with_path(target)[0]):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(p))


def test_bf16_activations_flow_in_bf16(runs):
    """Inside the bf16 engine the processor's blocks produce bf16 (the
    concats do not promote back to f32); the physics wrapper's output is
    f32."""
    _, engines = runs
    eng = engines[BF16]
    seen = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, o, name=name: seen.__setitem__(name, o.dtype))
        for name, m in eng.model.named_modules()
        if name.endswith(("fno_layers.0", "unet_layers.0", "encoder"))]
    try:
        u0, cond, sc = _inputs()
        assert eng.step(u0, cond=cond, spatial_cond=sc).dtype == np.float32
    finally:
        for h in hooks:
            h.remove()
    assert seen and set(seen.values()) == {torch.bfloat16}, seen


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("ns512")
    generate(str(root / "ns512"), n_sims=4, n_channels=1, nt=NT, nx1=N,
             nx2=N, seed=4)
    return root


def _dataset(root):
    return PDE2DDataset(str(root), "ns512", "memmap", "snapshots",
                        conditioning="conditioning",
                        spatial_conditioning="spatial_conditioning",
                        c_filter=[0], split_file="split", name="ns512")


def test_engine_serves_the_first_window_of_a_split(split):
    """``from_config`` on the port's config with narrowing overrides, on
    the CPU, over the PDE of a synthetic split read through
    ``PDE2DDataset``: its first window rolls out, finite, in bf16, and
    within the bf16 sanity bound of the same weights in f32."""
    ds = _dataset(split)
    _, u, x, cond, _, sc = ds.train[0]
    assert u.shape == (1, NT, N, N) and x.shape == (N, N, 2)
    u0 = np.asarray(u)[None, :, :TW]
    cond, sc = np.asarray(cond)[None], np.asarray(sc)[None]
    roll = {}
    for dtype in (None, BF16):
        eng = SurrogateEngine.from_config(PORT_CFG, pde=ds.pde,
                                          overrides=OVERRIDES, device="cpu",
                                          compute_dtype=dtype or "float32")
        eng.init_params(seed=0)
        roll[dtype] = eng.rollout(u0, 2, cond=cond, spatial_cond=sc)
    assert eng.compute_dtype == torch.bfloat16
    assert SurrogateEngine.from_config(
        PORT_CFG, pde=ds.pde, overrides=OVERRIDES,
        device="cpu").compute_dtype == torch.bfloat16   # the config's
    assert roll[BF16].shape == (1, 1, 2 * TW, N, N)
    assert np.isfinite(roll[BF16]).all()
    scale = np.abs(roll[None]).max()
    assert np.abs(roll[BF16] - roll[None]).max() / scale < 5e-2


def test_bf16_artifact_equals_the_engine(runs, tmp_path):
    """The bf16 model exported (its spectral nodes carry bf16, as the op's
    fake now says) and reloaded serves what the engine serves."""
    _, engines = runs
    eng = engines[BF16]
    u0, cond, sc = _inputs()
    path = str(tmp_path / "ns512.npst")
    eng.export_rollout(path, STEPS, u0, cond=cond, spatial_cond=sc)
    art = load_exported(path)
    assert art.meta["compute_dtype"] == "torch.bfloat16"
    spectral = [n for n in art._module.graph.nodes
                if n.target == torch.ops.nps_torch.spectral_dft2d_fwd.default]
    assert len(spectral) == 2
    assert {n.meta["val"].dtype for n in spectral} == {torch.bfloat16}
    got = art.rollout(u0, cond=cond, spatial_cond=sc)
    want = eng.rollout(u0, STEPS, cond=cond, spatial_cond=sc)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("remat,policy", [(True, "save_conv_outputs"),
                                          (True, None), (False, None)])
def test_ufno_takes_the_jax_remat_values(remat, policy):
    m = UFNO(num_spatial_dims=2, hidden_features=8, hidden_blocks=1,
             fno_modes=2, ch_mults=(1,), is_attn=(False,), remat=remat,
             remat_policy=policy)
    assert (m.remat, m.remat_policy) == (remat, policy)


def test_ufno_refuses_an_unknown_remat_policy():
    with pytest.raises(ValueError, match="remat policy"):
        UFNO(num_spatial_dims=2, hidden_features=8, hidden_blocks=1,
             fno_modes=2, ch_mults=(1,), is_attn=(False,), remat=True,
             remat_policy="save_everything")


def _argv(split, tmp_path, extra=()):
    return [*OVERRIDES, f"--dataset.base_path={split}",
            f"--experiment_path={tmp_path}", *extra]


def _parse(fn, cfg, argv):
    saved = sys.argv
    try:
        sys.argv = ["prog", *argv]
        return fn(cfg)
    finally:
        sys.argv = saved


def test_trainer_refuses_bf16_naming_p12b(split, tmp_path, monkeypatch):
    """The name is older than bf16 training and than data parallelism: the
    trainer takes the config's bf16 (ROADMAP P12b is done) as its compute
    dtype and the config's ``data_parallel=True`` as the single-device step
    of a one-process world (P9a is done), and as this rank's share of a
    world of two (P9b items 1-2 are done; tests/test_torch_distributed.py
    trains such worlds). Still refused: a launcher's world of two with no
    process group, and spatial parallelism (P9b item 3 is done:
    tests/test_torch_spatial.py trains this config's shape at K = 2) over
    K ranks whose grid rows do not split at every U-Net level."""
    def build(extra=()):
        return train_cli.get_config_static(
            _parse(port_parse_args, PORT_CFG, _argv(split, tmp_path, extra)),
            device="cpu")[4]

    trainer = build()
    assert trainer.compute_dtype == torch.bfloat16
    assert trainer.config.data_parallel is True
    assert (trainer.data_parallel, trainer.rank, trainer.world) == \
        (False, 0, 1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="init_distributed"):
        build()
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    trainer = build()
    assert (trainer.data_parallel, trainer.rank, trainer.world) == \
        (True, 1, 2)
    assert trainer.compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="spatial_parallel=3: the grid's "
                                         "32 rows"):
        build(["--trainer.spatial_parallel=3"])


# the train-step parity: 1 block x 8 features (the JAX side compiles a
# rematerialized step per compute dtype)
TRAIN_OVERRIDES = ["--model.hidden_features=8", "--model.hidden_blocks=1"]


@pytest.fixture(scope="module")
def train_runs(split, tmp_path_factory):
    """One train step at depths 0 and 1 by the port's trainer (bf16, from
    the config) and by the JAX loss and gradients rebuilt eagerly (as
    ``test_torch_train.py`` does) in f32 and bf16, the same weights,
    batch and start steps: {(side, dtype, depth): (loss, {name: grad})}."""
    out_dir = tmp_path_factory.mktemp("ns512_train")
    argv = _argv(split, out_dir, TRAIN_OVERRIDES)
    jt = jax_build(_parse(jax_parse_args, JAX_CFG, argv))[5]
    pt = train_cli.get_config_static(_parse(port_parse_args, PORT_CFG, argv),
                                     device="cpu")[4]
    assert pt.compute_dtype == torch.bfloat16
    assert [(m.remat, m.remat_policy) for m in pt.model.modules()
            if isinstance(m, UFNO)] == [(True, "save_conv_outputs")]
    pt.init_params(seed=0)
    pt.set_optimizer(dict(object="optim.Adam", lr=1e-4))
    params = {"params": {"inner": convert_state_dict(
        pt.model.state_dict())["params"]}}
    batch = next(iter(JaxHostDataLoader(jt.data.train, B, seed=0,
                                        process_index=0, process_count=1)))
    _, u, x, cond, _, sc = (jnp.asarray(a) for a in batch)
    pde, mi = jt.data.pde, jt.model.model_interface
    state = {k: v.clone() for k, v in pt.model.state_dict().items()}
    steps0 = np.array([TW, 2 * TW - 1])
    out = {}
    for depth in (0, 1):
        pt.model.load_state_dict(state)
        loss, _ = pt.train_step(tuple(torch.from_numpy(np.asarray(a))
                                      for a in batch), 0, 0, unrolled=depth,
                                steps0=steps0)
        out["port", BF16, depth] = (float(loss), {
            k: p.grad.numpy() for k, p in pt.model.named_parameters()})
    try:
        for dtype in (None, BF16):
            jconfig.set_compute_dtype(dtype)
            apply = jax.jit(lambda p, d: jt.model.apply(
                p, d, cond=cond, bc=None, pos=x, t_cond=None, spatial_cond=sc))

            def loss_fn(p, data, labels):
                pred, _ = jax_process_step(pde, mi, apply(p, data), labels,
                                           None, get_bc=False,
                                           process_settings={})
                return jnp.sqrt(jt.criterion(pred, labels))

            value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
            for depth in (0, 1):
                steps = jnp.asarray(steps0)
                data, labels = window(u, steps, TW, "both")
                with jax.default_matmul_precision("highest"):
                    for _ in range(depth):
                        pred = apply(params, data)
                        labels_prev, steps = labels, steps + TW
                        labels = window(u, steps, TW, "labels")
                        data, _ = jax_process_step(pde, mi, pred, labels_prev,
                                                   labels, process_settings={})
                    loss, grads = value_and_grad(params, data, labels)
                out["jax", dtype, depth] = (float(loss), {
                    k: v.numpy() for k, v in from_jax_params(
                        jax.tree_util.tree_map(np.asarray, grads)).items()})
    finally:
        jconfig.set_compute_dtype(None)
    return out


@pytest.mark.parametrize("depth", [0, 1])
def test_bf16_train_step_matches_jax_bf16(train_runs, depth):
    """The port's bf16 train step (remat, K1 and K2 through their plain
    versions) against the JAX package's bf16 step, within max(2 d_jax,
    8e-3): the loss relative to JAX f32's, and each parameter's gradient
    (f32) as an RMS relative to the RMS of JAX f32's gradient (or 1e-4 of
    the largest such RMS where it is smaller), as the rollout bar uses the
    nRMSE: a gradient sums many bf16-rounded products, and the element-wise
    largest deviation of two independent roundings runs near 2 d_jax by
    itself."""
    loss, grads = train_runs["port", BF16, depth]
    l32, g32 = train_runs["jax", None, depth]
    lbf, gbf = train_runs["jax", BF16, depth]
    d_jax = abs(lbf - l32) / abs(l32)
    err = abs(loss - lbf) / abs(l32)
    assert np.isfinite(loss) and err <= max(2 * d_jax, BF16_FLOOR), \
        (err, d_jax)
    assert set(grads) == set(g32)

    def rms(a):
        return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))

    floor = 1e-4 * max(rms(g) for g in g32.values())
    for k, g in grads.items():
        assert g.dtype == np.float32, k
        scale = max(rms(g32[k]), floor)
        d_jax = rms(gbf[k] - g32[k]) / scale
        err = rms(g - gbf[k]) / scale
        assert err <= max(2 * d_jax, BF16_FLOOR), (k, err, d_jax)


def test_cli_epoch_in_bf16(split, tmp_path, capsys):
    """One epoch of the training CLI on the config (bf16, remat) over the
    32 x 32 split on the CPU: finite train and validation losses, the
    metrics line and the saved models."""
    trainer = train_cli.cli(["prog", "-C", PORT_CFG, "--device", "cpu",
                             *_argv(split, tmp_path, [
                                 *TRAIN_OVERRIDES, "--trainer.num_epochs=1",
                                 "--trainer.test_interval=1",
                                 "--trainer.print_interval=1",
                                 "--experiment_name=ns512_bf16"])])
    assert trainer.compute_dtype == torch.bfloat16
    save = trainer.config.save_path
    with open(save + "_metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 1 and np.isfinite(rows[0]["train_loss"])
    assert np.isfinite(rows[0]["default - val loss"])
    assert (tmp_path / "ns512_bf16_final.pt").exists()
    assert "Epoch 0" in capsys.readouterr().out


def test_kernel_variant_by_shape():
    """The ns512 spectral call takes the large-plane variant, forward and
    backward, in bf16 and in f32 (m2 = 20); every twophase call keeps the
    resident kernels in f32 and takes the large-plane ones in bf16."""
    assert tsp._check_kernel_fits(8, 132, 512, 512, 20, 20,
                                  c_out=128) == "large"
    assert tsp._check_kernel_fits(2, 36, 512, 512, 20, 20, bf16=True,
                                  c_out=32) == "large"
    for b in (4, 16):   # the twophase U-FNO's serving and train batches
        assert tsp._check_kernel_fits(b, 196, 96, 64, 10, 10,
                                      c_out=192) == "resident"
        assert tsp._check_kernel_fits(b, 196, 96, 64, 10, 10,
                                      "spectral_dft2d_bwd") == "resident"
    assert tsp._check_kernel_fits(4, 196, 96, 64, 10, 10, bf16=True) == \
        "large"
    for bf16 in (True, False):   # the input gradient: dy's 128 -> 132
        assert tsp._check_kernel_fits(8, 128, 512, 512, 20, 20,
                                      "spectral_dft2d_bwd", bf16=bf16,
                                      c_out=132) == "large"
    assert tsp._check_kernel_fits(16, 192, 96, 64, 10, 10,
                                  "spectral_dft2d_bwd", bf16=True,
                                  c_out=196) == "large"
    with pytest.raises(ValueError, match="65535 planes"):
        tsp._check_kernel_fits(600, 128, 512, 512, 20, 20,
                               "spectral_dft2d_bwd", bf16=True, c_out=132)
    with pytest.raises(ValueError, match="m2 <= 32"):
        tsp._check_kernel_fits(1, 4, 512, 512, 20, 40)
    with pytest.raises(ValueError, match="at most 1024 points"):
        tsp._check_kernel_fits(1, 4, 64, 2048, 4, 20)
