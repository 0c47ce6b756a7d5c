"""Module-level parity of the port against ``nps_tpu``, after a weight
transplant through ``nps_tpu_torch.compat.from_jax_params``.

Each JAX module is initialised from a fixed key on numpy inputs; its params
load strictly into the port module, and both run the same inputs (JAX in
channels-last, the port in NCHW). Bar: max|d| / max|ref| < 1e-4 (ROADMAP
"How a part is held"), JAX at precision="highest".
"""

import jax
import numpy as np
import pytest
import torch

import nps_tpu.models.common as jc
import nps_tpu.models.dec_grid as jdec
import nps_tpu.models.fno as jfno
import nps_tpu.models.unet_modern as junet
from nps_tpu.models.activation_wrapper import volume_preserve as jax_vp
from nps_tpu.pde import PDE2D as JaxPDE2D
import nps_tpu_torch.models.common as tc
import nps_tpu_torch.models.dec_grid as tdec
import nps_tpu_torch.models.fno as tfno
import nps_tpu_torch.models.unet_modern as tunet
from nps_tpu_torch.models.activation_wrapper import volume_preserve
from nps_tpu_torch.compat import from_jax_params
from nps_tpu_torch.pde import PDE2D

REL = 1e-4
PDE_KW = dict(tmin=0, tmax=10, nt=51, L1=1.0, L2=0.7, nx1=12, nx2=10,
              x=None, name="twophase", n_cond_static=2, n_cond_spatial=2)


def _rel(a, ref):
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _cl(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _transplant(jmod, tmod, *args, **kwargs):
    """Init ``jmod`` on ``args``, load its params into ``tmod``; return the
    JAX output (from the same traced call as the init: one compile)."""
    with jax.default_matmul_precision("highest"):
        ref, params = jax.jit(jmod.init_with_output)(jax.random.PRNGKey(0),
                                                     *args, **kwargs)
    params = jax.tree_util.tree_map(np.asarray, params)
    tmod.load_state_dict(from_jax_params(params), strict=True)
    return np.asarray(ref)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("kw", [
    dict(kernel_size=3, padding="same", padding_mode="circular"),
    dict(kernel_size=3, padding="valid"),
    dict(kernel_size=3, padding="valid", strides=2),
    dict(kernel_size=1, padding="valid"),
    # the Dilated ResNet's widest conv: a wrap of 16 cells per side, wider
    # than both axes (it wraps around more than once), and a narrower one
    dict(kernel_size=5, padding="same", padding_mode="circular", dilation=8),
    dict(kernel_size=5, padding="same", padding_mode="circular", dilation=2),
])
def test_convnd(kw):
    x = _x(0, (2, 11, 9, 5))
    ref = _transplant(jc.ConvND(features=6, num_spatial_dims=2, **kw),
                      t := tc.ConvND(5, 6, num_spatial_dims=2, **kw), x)
    out = _cl(t(_nchw(x)))
    assert out.shape == ref.shape and _rel(out, ref) < REL


@pytest.mark.parametrize("pre_pad", [0, 1])
def test_conv_transpose(pre_pad):
    x = _x(1, (2, 5, 4, 3))
    kw = dict(kernel_size=4, num_spatial_dims=2, strides=2, pre_pad=pre_pad)
    jmod = jc.ConvTransposeND(features=6, **kw)
    params = jmod.init(jax.random.PRNGKey(0), x)["params"]
    ref = np.asarray(jmod.apply({"params": params}, x))
    t = tc.ConvTransposeND(3, 6, **kw)
    # a bare transposed conv: its [*k, I, O] kernel maps to [I, O, *k]
    # (from_jax_params knows it by its U-Net path, up_N/conv)
    t.load_state_dict({
        "weight": torch.from_numpy(np.transpose(np.asarray(params["kernel"]),
                                                (2, 3, 0, 1))
                                   .copy()),
        "bias": torch.from_numpy(np.asarray(params["bias"]).copy())})
    out = _cl(t(_nchw(x)))
    assert out.shape == ref.shape and _rel(out, ref) < REL


@pytest.mark.parametrize("src,dst", [
    ((9, 8), (12, 10)),   # pad: odd and even differences
    ((12, 11), (9, 8)),   # crop: odd and even differences
    ((10, 7), (7, 10)),   # crop one axis, pad the other
])
def test_crop_nd_tie_breaks(src, dst):
    x = _x(2, (2, 3) + src)
    ref = np.asarray(jc.crop_nd(x, (1, 1) + dst, 2, channels_last=False))
    out = tc.crop_nd(torch.from_numpy(x), (1, 1) + dst, 2).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("cin,cout,mode", [(10, 8, "circular"),
                                           (8, 8, "circular"),
                                           (8, 8, "ones")])
def test_residual_block(cin, cout, mode):
    x = _x(3, (2, 12, 10, cin))
    kw = dict(activation="gelu", norm=True, num_spatial_dims=2,
              padding_mode=mode)
    ref = _transplant(junet.ResidualBlock(cin, cout, **kw),
                      t := tunet.ResidualBlock(cin, cout, **kw), x)
    assert _rel(_cl(t(_nchw(x))), ref) < REL


@pytest.mark.parametrize("mode", ["circular", "ones"])
def test_unet_modern(mode):
    x = _x(4, (2, 24, 16, 8))
    vb = _x(5, (2, 24, 16, 4))
    kw = dict(num_spatial_dims=2, n_cond=4, hidden_features=8,
              activation="gelu", norm=True, ch_mults=(1, 1),
              is_attn=(False, False), n_blocks=1, use1x1=True,
              padding_mode=mode)
    ref = _transplant(junet.UNetModern(**kw), t := tunet.UNetModern(**kw), x,
                      variables_broadcast=vb)
    out = _cl(t(_nchw(x), variables_broadcast=_nchw(vb)))
    assert out.shape == ref.shape and _rel(out, ref) < REL


def test_unet_modern_config_levels():
    """cfg_twophase_unet's geometry at a small width: ch_mults [2, 2, 1, 2]
    with two blocks per level on the 96x64 grid (96x64 -> 47x31 -> 23x15
    -> 11x7, valid convs down to 9x5, transposed convs growing the up path
    past the skips): crop_nd's tie-breaks and the circular-pad-then-valid
    convs at the small levels, which a smaller grid cannot reach."""
    x = _x(10, (1, 96, 64, 8))
    vb = _x(11, (1, 96, 64, 4))
    kw = dict(num_spatial_dims=2, n_cond=4, hidden_features=8,
              activation="gelu", norm=True, ch_mults=(2, 2, 1, 2),
              is_attn=(False,) * 4, n_blocks=2, use1x1=True,
              padding_mode="circular")
    ref = _transplant(junet.UNetModern(**kw), t := tunet.UNetModern(**kw), x,
                      variables_broadcast=vb)
    out = _cl(t(_nchw(x), variables_broadcast=_nchw(vb)))
    assert out.shape == ref.shape and _rel(out, ref) < REL


def test_fno_layer():
    x = _x(6, (2, 16, 12, 6))
    kw = dict(num_spatial_dims=2, modes=4, hidden_dim_out=5, activation=None,
              padding_mode="circular")
    ref = _transplant(jfno.FNO_Layer(hidden_dim=6, **kw),
                      t := tfno.FNO_Layer(6, **kw), x)
    assert _rel(_cl(t(_nchw(x))), ref) < REL


def test_time_conv_dense():
    h = _x(7, (2, 12, 10, 8))
    u = _x(8, (2, 1, 5, 12, 10))
    kw = dict(num_c=1, num_spatial_dims=2, time_window=5, hidden_features=8,
              activation="gelu", dec_delta_mode="per_step")
    ref = _transplant(jdec.TimeConvDense(pde=JaxPDE2D(**PDE_KW), **kw),
                      t := tdec.TimeConvDense(pde=PDE2D(**PDE_KW), **kw),
                      h, u)
    out = t(_nchw(h), torch.from_numpy(u)).detach().numpy()
    assert out.shape == ref.shape and _rel(out, ref) < REL


@pytest.mark.parametrize("mode", ["block", "individual", "individual_static"])
def test_volume_preserve(mode):
    rng = np.random.default_rng(9)
    u = (0.2 + rng.random((2, 1, 5, 12, 10))).astype(np.float32)
    u_prev = (0.2 + rng.random((2, 1, 5, 12, 10))).astype(np.float32)
    ref = np.asarray(jax_vp(u, u_prev, mode, 1 / 25))
    out = volume_preserve(torch.from_numpy(u), torch.from_numpy(u_prev),
                          mode, 1 / 25).numpy()
    assert _rel(out, ref) < REL


def test_volume_preserve_rejects_unknown_mode():
    u = torch.ones(1, 1, 2, 4, 4)
    with pytest.raises(ValueError):
        volume_preserve(u, u, "nope", 1.0)


def test_pde2d_keeps_the_dt_quirk():
    """PDE2D's dt is tmax/(nt-1), not (tmax-tmin)/(nt-1), in both packages;
    the decoder's per-step delta scales by it. The grid matches too."""
    kw = dict(PDE_KW, tmin=2.0, tmax=10.0, nt=5)
    port, ref = PDE2D(**kw), JaxPDE2D(**kw)
    assert port.dt == ref.dt == 2.5
    np.testing.assert_array_equal(port.x, ref.x)
