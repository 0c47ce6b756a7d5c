"""The U-Net's ``AttentionBlock`` in the port against ``nps_tpu``: the block
alone (forward, gradients, and a check that a softmax over the keys would
fail), a small modern U-Net with attention on its two levels and in the
middle (forward, gradients, the weights' round trip with the unused
``norm`` parameters), and ``cfg_twophase_unet`` served with ``is_attn`` and
``mid_attn`` on (one step and a 3-step rollout against the JAX engine).

JAX weights go into the port through ``from_jax_params`` and back through
``convert_state_dict``. Bars (ROADMAP "How a part is held"): forward
max|d| / max|ref| < 1e-4, gradients < 5e-3 per tensor, rollout nRMSE <
1e-3. JAX runs at precision "highest"; PyTorch on two threads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nps_tpu.models.unet_modern as junet
from nps_tpu.compat import convert_state_dict
from nps_tpu.inference import SurrogateEngine as JaxEngine
from nps_tpu.pde import PDE2D as JaxPDE2D
from nps_tpu_torch.compat.jax_weights import from_jax_params
from nps_tpu_torch.inference import SurrogateEngine
import nps_tpu_torch.models.unet_modern as tunet
from nps_tpu_torch.pde import PDE2D

REL_FWD, REL_GRAD, NRMSE = 1e-4, 5e-3, 1e-3
NT, NX1, NX2, TW, B = 21, 24, 16, 5, 2
PDE_KW = dict(tmin=0, tmax=10, nt=NT, L1=1.0, L2=0.7, nx1=NX1, nx2=NX2,
              x=None, name="twophase", n_cond_static=2, n_cond_spatial=2)
UNET_CFG = "nps_tpu/configs/train/cfg_twophase_unet.py"
PORT_UNET_CFG = "nps_tpu_torch/configs/train/cfg_twophase_unet.py"
ATTN = ["--model.hidden_features=8", "--model.ch_mults=[2,1]",
        "--model.is_attn=[True,True]", "--model.mid_attn=true"]


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _softmax_over(scores, axis):
    e = np.exp(scores - scores.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def test_attention_block_forward_gradient_and_query_softmax():
    """Output and the gradients of the input and of every parameter against
    jax.vjp; the block written out in numpy with the softmax over the
    queries gives JAX's output, and with the softmax over the keys (what
    ``scaled_dot_product_attention`` computes) misses it by far."""
    rng = np.random.default_rng(0)
    b, c, sp = 2, 6, (5, 4)
    x = rng.standard_normal((b, *sp, c)).astype(np.float32)
    dy = rng.standard_normal((b, *sp, c)).astype(np.float32)
    jm = junet.AttentionBlock(c)
    params = _np(jm.init(jax.random.PRNGKey(3), x)["params"])
    assert set(params) == {"norm", "projection", "output"}
    with jax.default_matmul_precision("highest"):
        ref, vjp = jax.vjp(lambda p, x: jm.apply({"params": p}, x), params,
                           jnp.asarray(x))
        g_params, g_x = vjp(jnp.asarray(dy))
    ref = np.asarray(ref)

    h = x.reshape(b, -1, c).astype(np.float64)
    qkv = h @ params["projection"]["kernel"] + params["projection"]["bias"]
    q, k, v = np.split(qkv, 3, axis=-1)
    scores = np.einsum("bid,bjd->bij", q, k) * c ** -0.5
    for axis, close in ((1, True), (2, False)):
        res = _softmax_over(scores, axis) @ v
        out = res @ params["output"]["kernel"] + params["output"]["bias"] + h
        assert (_rel(out.reshape(ref.shape), ref) < REL_FWD) == close, axis

    tm = tunet.AttentionBlock(c)
    tm.load_state_dict(from_jax_params(params), strict=True)
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy()).requires_grad_()
    out = tm(xt)
    (out * torch.from_numpy(np.moveaxis(dy, -1, 1).copy())).sum().backward()
    assert _rel(np.moveaxis(out.detach().numpy(), 1, -1), ref) < REL_FWD
    assert _rel(np.moveaxis(xt.grad.numpy(), 1, -1), g_x) < REL_GRAD
    ref_g = from_jax_params(_np(g_params))
    for k, p in tm.named_parameters():
        if k.startswith("norm."):   # defined, never applied: no gradient
            assert p.grad is None and not np.abs(ref_g[k].numpy()).any()
            continue
        assert _rel(p.grad.numpy(), ref_g[k].numpy()) < REL_GRAD, k


def _unet_pair(seed=1):
    """A modern U-Net of two levels (8 and 16 features) with attention on
    both and in the middle, JAX's weights in the port; its input and
    conditioning grid."""
    rng = np.random.default_rng(seed)
    kw = dict(num_spatial_dims=2, n_cond=3, hidden_features=8,
              activation="gelu", norm=True, ch_mults=(2, 1),
              is_attn=(True, True), mid_attn=True, n_blocks=1,
              use1x1=True, padding_mode="circular")
    h = rng.standard_normal((B, NX1, NX2, 8)).astype(np.float32)
    vb = rng.standard_normal((B, NX1, NX2, 3)).astype(np.float32)
    jm = junet.UNetModern(**kw)
    params = _np(jax.jit(lambda: jm.init(jax.random.PRNGKey(seed), h,
                                         variables_broadcast=vb))())
    tm = tunet.UNetModern(**kw)
    tm.load_state_dict(from_jax_params(params), strict=True)
    return jm, tm, params, h, vb


def test_unet_with_attention_forward_gradients_and_round_trip():
    """Forward and every gradient against jax.vjp; convert_state_dict of
    the port's weights is the JAX tree again, bit for bit, the attention
    blocks' unused norms included."""
    jm, tm, params, h, vb = _unet_pair()
    attn = [k for k in tm.state_dict() if ".attn." in k]
    assert {k.split(".attn.")[1] for k in attn} == {
        "norm.weight", "norm.bias", "projection.weight", "projection.bias",
        "output.weight", "output.bias"}
    assert len(attn) == 6 * 7   # 2 down blocks, the middle, 4 up blocks
    dy = np.random.default_rng(2).standard_normal(h.shape).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref, vjp = jax.vjp(lambda p: jm.apply(p, h, variables_broadcast=vb),
                           params)
        (g_params,) = vjp(jnp.asarray(dy))
    nchw = lambda a: torch.from_numpy(np.moveaxis(a, -1, 1).copy())  # noqa
    out = tm(nchw(h), variables_broadcast=nchw(vb))
    (out * nchw(dy)).sum().backward()
    assert _rel(np.moveaxis(out.detach().numpy(), 1, -1), ref) < REL_FWD
    ref_g = from_jax_params(_np(g_params))
    floor = 1e-5 * max(float(np.abs(g.numpy()).max())
                       for g in ref_g.values())
    for k, p in tm.named_parameters():
        if ".attn.norm." in k:
            assert p.grad is None
            continue
        ref_k, got = ref_g[k].numpy(), p.grad.numpy()
        if np.abs(ref_k).max() < floor:
            # zero in exact arithmetic (the last up block's output bias,
            # under the final GroupNorm of one channel a group): f32 noise
            # on both sides
            assert np.abs(got).max() < floor, k
            continue
        assert _rel(got, ref_k) < REL_GRAD, k
    back = convert_state_dict(tm.state_dict())["params"]
    flat = jax.tree_util.tree_flatten_with_path(back)[0]
    ref_flat = dict(jax.tree_util.tree_flatten_with_path(
        params["params"])[0])
    assert len(flat) == len(ref_flat)
    for path, v in flat:
        np.testing.assert_array_equal(v, ref_flat[path],
                                      err_msg=jax.tree_util.keystr(path))


def test_unet_config_with_attention_serves_as_jax():
    """``cfg_twophase_unet`` with ``is_attn`` on both levels and
    ``mid_attn``, served by both engines on the JAX weights: one step and
    a 3-step rollout."""
    over = [f"--time_window={TW}", *ATTN]
    jeng = JaxEngine.from_config(UNET_CFG, pde=JaxPDE2D(**PDE_KW),
                                 overrides=over)
    rng = np.random.default_rng(4)
    u0 = (0.1 + 0.8 * rng.random((B, 1, TW, NX1, NX2))).astype(np.float32)
    cond = rng.random((B, 2)).astype(np.float32)
    sc = (rng.random((B, 2, NX1, NX2)) > 0.8).astype(np.float32)
    jeng.init_params(u0, cond=cond, spatial_cond=sc, seed=5)
    teng = SurrogateEngine.from_config(PORT_UNET_CFG, pde=PDE2D(**PDE_KW),
                                       overrides=over, device="cpu")
    teng.load_jax_params(_np(jeng.params))
    n_attn = sum(1 for path, _ in jax.tree_util.tree_flatten_with_path(
        jeng.params)[0] if "'attn'" in jax.tree_util.keystr(path)
        and "'projection'" in jax.tree_util.keystr(path)
        and "'kernel'" in jax.tree_util.keystr(path))
    assert n_attn == 11   # n_blocks 2: 4 down, the middle, 6 up
    assert sum(type(m).__name__ == "AttentionBlock"
               for m in teng.model.modules()) == n_attn
    with jax.default_matmul_precision("highest"):
        ref = jeng.rollout(u0, n_steps=3, cond=cond, spatial_cond=sc)
    step = teng.step(u0, cond=cond, spatial_cond=sc)
    assert _rel(step, ref[:, :, :TW]) < REL_FWD
    roll = teng.rollout(u0, n_steps=3, cond=cond, spatial_cond=sc)
    assert roll.shape == ref.shape == (B, 1, 3 * TW, NX1, NX2)
    nrmse = np.sqrt(np.mean((roll - ref) ** 2) / np.mean(ref ** 2))
    assert nrmse < NRMSE
