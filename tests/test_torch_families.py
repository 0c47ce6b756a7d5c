"""The three other twophase families against ``nps_tpu``: the Dilated ResNet
(``cfg_twophase_drn``), the modern U-Net (``cfg_twophase_unet``) and the
FNO -> U-FNO chain (``cfg_twophase_ufno_fno``), each at a small size, built
by both packages from their own configs, JAX weights carried into the port
with ``from_jax_params``.

Sizes: DRN 16 features x 1 block (kernel 5, dilations up to 8: a wrap-pad
of 16 cells per side on the 16-cell axis); U-Net 8 features with
``ch_mults=[2, 1]``; FNO -> U-FNO 16 features with 4 modes. 24x16 grid,
time window 5, 21 frames (depth 2 is the deepest injected). PyTorch runs on
two threads, since the suite's workers share the machine's cores.

Bars (ROADMAP "How a part is held"): forward max|d| / max|ref| < 1e-4;
3-step rollout nRMSE < 1e-3; train-step loss rtol 2e-3 at injected depths
0 and 2; every gradient max|d| / max|ref| < 5e-3 (``jax.grad`` of the JAX
loss). Also the FNO processor with ``cond_mode='film'`` (FiLM mode 0) and a
FiLM layer in mode 1: output and gradients, inputs and FiLM vector
included, against ``jax.grad``. JAX runs at precision "highest".
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
from nps_tpu.models import fno as jfno
from nps_tpu.pde import PDE2D as JaxPDE2D
from nps_tpu.train.pushforward import window
from nps_tpu.train_cli import get_config_static as jax_build
from nps_tpu.utils.process_output import process_step as jax_process_step
from nps_tpu_torch import train_cli
from nps_tpu_torch.compat.jax_weights import from_jax_params
from nps_tpu_torch.configs.parse import parse_args as port_parse_args
from nps_tpu_torch.data.synthetic import generate
from nps_tpu_torch.inference import SurrogateEngine
from nps_tpu_torch.models import fno as tfno
from nps_tpu_torch.pde import PDE2D

NT, NX1, NX2, TW, B = 21, 24, 16, 5, 2
DEPTHS = (0, 2)
REL_FWD, NRMSE, REL_LOSS, REL_GRAD = 1e-4, 1e-3, 2e-3, 5e-3
FAMILIES = {
    "drn": ["--model.hidden_features=16", "--model.hidden_blocks=1"],
    "unet": ["--model.hidden_features=8", "--model.ch_mults=[2,1]"],
    "ufno_fno": ["--model.hidden_features=16", "--model.fno_modes=4"],
}
PDE_KW = dict(tmin=0, tmax=10, nt=NT, L1=1.0, L2=0.7, nx1=NX1, nx2=NX2,
              x=None, name="twophase", n_cond_static=2, n_cond_spatial=2)


def _cfgs(family):
    return (f"nps_tpu/configs/train/cfg_twophase_{family}.py",
            f"nps_tpu_torch/configs/train/cfg_twophase_{family}.py")


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
    root = tmp_path_factory.mktemp("families")
    generate(str(root / "data" / "twophase"), n_sims=8, n_channels=1, nt=NT,
             nx1=NX1, nx2=NX2, seed=3)
    return root


def _argv(family, data_dir, extra=()):
    return [f"--base_resolution=[{NT},{NX1},{NX2}]",
            f"--super_resolution=[{NT},{NX1},{NX2}]",
            f"--time_window={TW}", f"--batch_size={B}",
            f"--dataset.base_path={data_dir / 'data'}",
            "--dataset.c_filter=[0]", *FAMILIES[family],
            f"--experiment_path={data_dir / family}",
            "--experiment_name=run", *extra]


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request, data_dir):
    """Both trainers of one family on the same split, the port's weights
    carried over from the JAX model's, and one batch."""
    name = request.param
    jax_cfg, port_cfg = _cfgs(name)
    argv = _argv(name, data_dir)
    jt = jax_build(_parse(jax_parse_args, jax_cfg, argv))[5]
    pt = train_cli.get_config_static(_parse(port_parse_args, port_cfg, argv),
                                     device="cpu")[4]
    loader = JaxHostDataLoader(jt.data.train, B, seed=0, process_index=0,
                               process_count=1)
    batch = next(iter(loader))
    with jax.default_matmul_precision("highest"):
        jt.init_params(batch)
    params0 = jax.tree_util.tree_map(np.asarray, jt.params)
    pt.load_jax_params(params0)
    pt.set_optimizer(dict(object="optim.Adam", lr=1e-4))
    return name, jt, pt, batch, params0


def _engines(fam):
    """Serving engines over the trainers' models (the same weights)."""
    name, jt, pt, _, params0 = fam
    jax_cfg, port_cfg = _cfgs(name)
    over = [f"--time_window={TW}", *FAMILIES[name]]
    jeng = JaxEngine.from_config(jax_cfg, pde=JaxPDE2D(**PDE_KW),
                                 overrides=over)
    jeng.params = jax.tree_util.tree_map(jnp.asarray, params0)
    teng = SurrogateEngine.from_config(port_cfg, pde=PDE2D(**PDE_KW),
                                       overrides=over, device="cpu")
    teng.load_jax_params(params0)
    return jeng, teng


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    u0 = (0.1 + 0.8 * rng.random((B, 1, TW, NX1, NX2))).astype(np.float32)
    cond = rng.random((B, 2)).astype(np.float32)
    sc = (rng.random((B, 2, NX1, NX2)) > 0.8).astype(np.float32)
    return u0, cond, sc


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_configs_parse_to_the_jax_dicts(name):
    """Each family's port config parses to the JAX config's groups, key for
    key (activation objects by class name), the reference's unused decoder
    keys included."""
    def parse(fn, cfg):
        args = _parse(fn, cfg, [])
        return {g: {k: (type(v).__name__ if hasattr(v, "_parse_override")
                        else v) for k, v in args[g].items()}
                if isinstance(args[g], dict) else args[g] for g in args}

    jax_cfg, port_cfg = _cfgs(name)
    assert parse(port_parse_args, port_cfg) == parse(jax_parse_args, jax_cfg)


def test_state_dict_round_trip(family):
    """The port's parameter names are the reference's: convert_state_dict of
    the port's state_dict is the JAX tree again, leaf for leaf (for DRN:
    processor.0.processor.B.layers.2L -> processor_0/block_B/conv_L)."""
    _, _, pt, _, params0 = family
    conv = {"params": {"inner": convert_state_dict(
        pt.model.state_dict())["params"]}}
    assert_params_match_structure(conv, params0)
    for (p, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(conv)[0],
            jax.tree_util.tree_flatten_with_path(params0)[0]):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(p))


def test_forward_and_rollout_match_jax(family):
    """The port's serving step against the first bundled step of the JAX
    rollout (the same model apply, one compile fewer), and the whole
    3-step rollouts."""
    jeng, teng = _engines(family)
    u0, cond, sc = _inputs()
    with jax.default_matmul_precision("highest"):
        ref_roll = jeng.rollout(u0, n_steps=3, cond=cond, spatial_cond=sc)
    out = teng.step(u0, cond=cond, spatial_cond=sc)
    ref = ref_roll[:, :, :TW]
    assert out.shape == ref.shape == (B, 1, TW, NX1, NX2)
    assert _rel(out, ref) < REL_FWD
    roll = teng.rollout(u0, n_steps=3, cond=cond, spatial_cond=sc)
    assert roll.shape == ref_roll.shape == (B, 1, 3 * TW, NX1, NX2)
    nrmse = np.sqrt(np.mean((roll - ref_roll) ** 2) / np.mean(ref_roll ** 2))
    assert nrmse < NRMSE


def _jax_loss_and_grads(jt, batch):
    """The shipped step's loss rebuilt eagerly (as tests/test_trainer.py
    does) and jax.grad of it, at an injected depth and start steps."""
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


def test_train_steps_match_jax(family):
    """Loss and every parameter's gradient at injected depths 0 and 2. A
    tensor whose gradient is below 1e-5 of the model's largest (zero in
    exact arithmetic, f32 noise on both sides) is held at that floor."""
    _, jt, pt, batch, params0 = family
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
        floor = 1e-5 * max(np.abs(r).max() for r in ref.values())
        for k, g in got.items():
            scale = max(np.abs(ref[k]).max(), floor)
            assert np.abs(g - ref[k]).max() / scale < REL_GRAD, (depth, k)


def test_cli_trains_one_epoch_on_cpu(family, data_dir):
    """One epoch of the family's config through the port's CLI: a finite
    train and validation loss, a metrics line and the saved model."""
    import os

    name = family[0]
    argv = ["prog", "-C", _cfgs(name)[1], "--device", "cpu",
            *_argv(name, data_dir, ["--trainer.num_epochs=1",
                                    "--trainer.test_interval=1",
                                    "--experiment_name=cli"])]
    trainer = train_cli.cli(argv)
    save = trainer.config.save_path
    with open(save + "_metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows] == [0]
    assert np.isfinite(rows[0]["train_loss"])
    assert np.isfinite(rows[0]["default - val loss"])
    assert os.path.exists(save + "_default.pt")


# ---- FiLM ---------------------------------------------------------------

def _film_case(seed, jmod, tmod, x_shape, n_cond):
    """Output and gradients (input, FiLM vector, every parameter) of the
    port's module against jax.vjp of the JAX one, the port's weights
    carried over by convert_state_dict (no JAX init to compile); both take
    (x, cond vector) positionally."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32)      # channels-last
    p = rng.standard_normal((x_shape[0], n_cond)).astype(np.float32)
    torch.manual_seed(seed)
    for m in tmod.modules():   # weights drawn from the seed
        if hasattr(m, "reset_parameters"):
            m.reset_parameters()
    params = convert_state_dict(tmod.state_dict())["params"]
    out_shape = x_shape[:-1] + (tmod(torch.zeros(1, x_shape[-1],
                                                 *x_shape[1:-1]),
                                     torch.zeros(1, n_cond)).shape[1],)
    dy = rng.standard_normal(out_shape).astype(np.float32)

    @jax.jit
    def value_and_vjp(pr, x, p):
        ref, vjp = jax.vjp(lambda pr, x, p: jmod.apply({"params": pr}, x, p),
                           pr, x, p)
        return ref, vjp(dy)

    with jax.default_matmul_precision("highest"):
        ref, (g_params, g_x, g_p) = value_and_vjp(params, x, p)
    ref = np.asarray(ref)
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy()).requires_grad_()
    pt_ = torch.from_numpy(p).requires_grad_()
    out = tmod(xt, pt_)
    (out * torch.from_numpy(np.moveaxis(dy, -1, 1).copy())).sum().backward()
    assert _rel(np.moveaxis(out.detach().numpy(), 1, -1), ref) < REL_FWD
    assert _rel(np.moveaxis(xt.grad.numpy(), 1, -1), np.asarray(g_x)) \
        < REL_GRAD
    assert _rel(pt_.grad.numpy(), np.asarray(g_p)) < REL_GRAD
    ref_g = from_jax_params(jax.tree_util.tree_map(np.asarray, g_params))
    got = dict(tmod.named_parameters())
    assert set(got) == set(ref_g)
    for k, t in got.items():
        assert _rel(t.grad.numpy(), ref_g[k].numpy()) < REL_GRAD, k


def test_fno_film_processor_matches_jax_grad():
    """The FNO processor with cond_mode='film' (its layers use FiLM mode 0,
    f = 1 + film): the cond vector reaches every spectral conv as p."""
    kw = dict(num_spatial_dims=2, n_cond=3, hidden_features=6, fno_modes=4,
              hidden_blocks=2, cond_mode="film")
    _film_case(11, jfno.FNO(remat=False, **kw), tfno.FNO(**kw),
               (2, 16, 12, 6), 3)


def test_fno_layer_film_mode_1_matches_jax_grad():
    """An FNO layer with FiLM mode 1 (f = film), the other factor."""
    kw = dict(num_spatial_dims=2, modes=(3, 4), feature_transform=True,
              feature_transform_dim=3, transform_mode=1, hidden_dim_out=5)
    _film_case(12, jfno.FNO_Layer(hidden_dim=6, **kw),
               tfno.FNO_Layer(6, **kw), (2, 16, 12, 6), 3)
