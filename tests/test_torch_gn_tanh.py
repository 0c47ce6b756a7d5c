"""K2 with the tanh GELU on the CPU.

The port's fused GroupNorm(1)+GELU with ``approximate="tanh"`` (the plain
version, the CPU half of the kernel's tanh epilogue) against
``nps_tpu``'s ``GroupNormFast`` followed by ``GELUTanh``: f32 at 1e-5 of
max|ref|; bf16 at max(2 d_jax, 8e-3), d_jax JAX's own bf16-vs-f32
deviation (the port rounds once from f32 where JAX normalises and applies
the GELU in bf16); gradients against ``jax.grad`` at 5e-3. A U-Net
``ResidualBlock`` with ``GELUTanh`` (weights carried across by
``from_jax_params``) against the JAX block at 1e-4, and it fuses both of its
GELUs into the op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nps_tpu.models.unet_modern as junet
from nps_tpu.models.activations import GELUTanh as JaxGELUTanh
from nps_tpu.models.common import GroupNormFast
import nps_tpu_torch.models.unet_modern as tunet
from nps_tpu_torch.compat import from_jax_params
from nps_tpu_torch.models.activations import (GELU, GELUTanh, Tanh,
                                              fused_gelu)
from nps_tpu_torch.ops import group_norm as gn

REL32, BF16_FLOOR, GRAD_RTOL, REL_BLOCK = 1e-5, 8e-3, 5e-3, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _rel(a, ref):
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _inputs(seed, shape=(2, 8, 12, 5)):
    """Channels-last x [b, h, w, C], scale, bias and an output weight."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 1.7 + 0.4).astype(np.float32)
    scale = (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(c)).astype(np.float32)
    wout = rng.standard_normal(shape).astype(np.float32)
    return x, scale, bias, wout


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _cl(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def _jax_gn_tanh(x, scale, bias):
    y = GroupNormFast(num_groups=1).apply(
        {"params": {"scale": scale, "bias": bias}}, x)
    return JaxGELUTanh()(y)


def test_fused_gelu_names_the_kernel_form():
    assert fused_gelu(GELU()) == "none" and fused_gelu("gelu") == "none"
    assert fused_gelu(GELUTanh()) == "tanh" and fused_gelu("gelu_tanh") == "tanh"
    assert fused_gelu(Tanh()) is None and fused_gelu(None) is None


def test_approximate_spellings_are_checked():
    x = torch.zeros(1, 2, 3, 3)
    with pytest.raises(ValueError, match="approximate"):
        gn.gn_gelu_plain(x, torch.ones(2), torch.zeros(2), True, gn.EPS,
                         "erf")


@pytest.mark.parametrize("grad", [False, True])
def test_gn_gelu_tanh_f32_matches_jax(grad):
    """No gradient: the custom op's CPU kernel; with one: the plain version
    under autograd. Both against GroupNormFast + GELUTanh."""
    x, scale, bias, _ = _inputs(0)
    ref = np.asarray(_jax_gn_tanh(jnp.asarray(x), scale, bias))
    xt = _nchw(x).requires_grad_(grad)
    out = gn.gn_gelu(xt, torch.from_numpy(scale), torch.from_numpy(bias),
                     approximate="tanh")
    assert out.dtype == torch.float32
    assert _rel(_cl(out), ref) < REL32
    plain = gn.gn_gelu_plain(_nchw(x), torch.from_numpy(scale),
                             torch.from_numpy(bias), approximate="tanh")
    assert _rel(_cl(plain), ref) < REL32


def test_gn_gelu_tanh_bf16_within_jax_bf16_bar():
    x, scale, bias, _ = _inputs(1, (2, 8, 12, 7))
    j32 = np.asarray(_jax_gn_tanh(jnp.asarray(x), scale, bias))
    j16 = np.asarray(_jax_gn_tanh(jnp.asarray(x, jnp.bfloat16), scale, bias)
                     .astype(jnp.float32))
    out = gn.gn_gelu(_nchw(x).to(torch.bfloat16), torch.from_numpy(scale),
                     torch.from_numpy(bias), approximate="tanh")
    assert out.dtype == torch.bfloat16
    scale_ref = np.abs(j32).max()
    d_jax = np.abs(j16 - j32).max() / scale_ref
    err = np.abs(_cl(out) - j16).max() / scale_ref
    assert err <= max(2 * d_jax, BF16_FLOOR), (err, d_jax)


def test_gn_gelu_tanh_gradients_match_jax_grad():
    """d/dx, d/dscale, d/dbias of sum(wout * GN+GELU(x)) against jax.grad."""
    x, scale, bias, wout = _inputs(2)

    def loss(x, s, b):
        return jnp.sum(jnp.asarray(wout) * _jax_gn_tanh(x, s, b))

    refs = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                             jnp.asarray(bias))
    xt = _nchw(x).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    out = gn.gn_gelu(xt, st, bt, approximate="tanh")
    (out * _nchw(wout)).sum().backward()
    got = (_cl(xt.grad), st.grad.numpy(), bt.grad.numpy())
    for g, r, name in zip(got, refs, ("dx", "dscale", "dbias")):
        assert _rel(g, np.asarray(r)) < GRAD_RTOL, name


@pytest.mark.parametrize("cin,cout", [(10, 8), (8, 8)])
def test_residual_block_with_gelu_tanh_matches_jax_and_fuses(monkeypatch,
                                                            cin, cout):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, 10, cin)).astype(np.float32)
    kw = dict(activation="gelu_tanh", norm=True, num_spatial_dims=2,
              padding_mode="circular")
    jmod = junet.ResidualBlock(cin, cout, **kw)
    with jax.default_matmul_precision("highest"):
        ref, params = jax.jit(jmod.init_with_output)(jax.random.PRNGKey(0), x)
    params = jax.tree_util.tree_map(np.asarray, params)
    t = tunet.ResidualBlock(cin, cout, **kw)
    t.load_state_dict(from_jax_params(params), strict=True)
    calls = []
    fused = gn.gn_gelu

    def record(x, weight, bias, gelu=True, eps=gn.EPS, approximate="none"):
        calls.append((gelu, approximate))
        return fused(x, weight, bias, gelu, eps, approximate)

    monkeypatch.setattr(tunet.ResidualBlock, "act",
                        property(lambda self: pytest.fail("unfused GELU")),
                        raising=False)
    import nps_tpu_torch.models.common as tcommon
    monkeypatch.setattr(tcommon, "gn_gelu", record)
    with torch.no_grad():
        out = t(_nchw(x))
    assert calls == [(True, "tanh"), (True, "tanh")]
    assert _rel(_cl(out), np.asarray(ref)) < REL_BLOCK


def test_gn_op_tanh_passes_opcheck():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 5, 7, generator=g)
    w, b = torch.randn(6, generator=g), torch.randn(6, generator=g)
    y = torch.ops.nps_torch.gn1_gelu_fwd(x, w, b, True, gn.EPS, "tanh")
    torch.testing.assert_close(
        y, gn.gn_gelu_plain(x, w, b, True, gn.EPS, "tanh"), rtol=0, atol=0)
    torch.library.opcheck(torch.ops.nps_torch.gn1_gelu_fwd.default,
                          (x, w, b, True, gn.EPS, "tanh"))

