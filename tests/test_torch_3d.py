"""The 3D path and the ``mix_impl`` field in the port against ``nps_tpu``
(the counterparts of ``tests/test_3d.py``, held against JAX directly: the
JAX file's reference-tree comparison has no port side): ``PDE3D``'s derived
fields, the 3D spectral conv alone (four corner blocks, forward and
gradients), the whole ``EncProcDec`` at ``num_spatial_dims=3`` with an FNO
and a Dilated ResNet processor (forward, every gradient, the weights' round
trip), the 3D mixture of spectral experts (forward and every gradient),
a 3D FNO grad step, FiLM in 3D refused as in JAX, and a model
spec's ``mix_impl`` values (an FNO layer built from a spec with each gives
JAX's output in 1D, 2D and 3D; an unknown value raises where the port reads
the spec, where the JAX package takes its FFT route for it).

Bars (ROADMAP "How a part is held"): forward max|d| / max|ref| < 1e-4,
gradients < 5e-3 per tensor, loss rtol 2e-3. JAX runs at precision
"highest"; PyTorch on two threads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nps_tpu.models as jm
import nps_tpu.models.fno as jfno
from nps_tpu.compat import convert_state_dict
from nps_tpu.ops.spectral import spectral_conv_nd as jax_spectral
from nps_tpu.pde import PDE3D as JaxPDE3D
from nps_tpu_torch.compat.jax_weights import from_jax_params
import nps_tpu_torch.models.fno as tfno
from nps_tpu_torch.models.enc_proc_dec import EncProcDec, create_model
from nps_tpu_torch.ops.spectral import spectral_conv_nd
from nps_tpu_torch.pde import PDE2D, PDE3D

TW, N_STATIC = 4, 2
NX = {"fno": (8, 6, 6), "drn": (10, 9, 8)}
REL_FWD, REL_GRAD, REL_LOSS = 1e-4, 5e-3, 2e-3


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


def _pde_kw(nx):
    return dict(tmin=0.0, tmax=1.0, nt=11, L1=1.0, L2=0.8, L3=0.6,
                nx1=nx[0], nx2=nx[1], nx3=nx[2], x=None, name="box3d",
                n_cond_static=N_STATIC)


def test_pde3d_derived_fields_match_jax():
    """dt (PDE2D's tmax/(nt-1)), extents, spacings, the grid and the
    conditioning counts."""
    kw = dict(_pde_kw((8, 6, 5)), tmin=0.5, n_cond_dynamic=3,
              n_cond_spatial=1, bc_mode="delta")
    got, ref = PDE3D(**kw), JaxPDE3D(**kw)
    for name in ("tmin", "tmax", "nt", "dt", "L", "nx1", "nx2", "nx3",
                 "dx1", "dx2", "dx3", "dxs", "n_cond_static",
                 "n_cond_dynamic", "n_cond_spatial", "num_spatial_dims",
                 "spatial_shape", "bc_mode", "name"):
        assert getattr(got, name) == getattr(ref, name), name
    assert got.dt == 1.0 / 10
    np.testing.assert_array_equal(got.x, ref.x)
    assert got.x.shape == (8, 6, 5, 3)


def test_spectral_conv_3d_forward_and_gradients():
    """The four corner blocks of m1 x m2 x m3 modes against the JAX FFT
    route: output, and the gradients of the input and of weights1..4
    (jax.vjp of the same cotangent)."""
    rng = np.random.default_rng(0)
    b, ci, co, sp, modes = 2, 3, 4, (8, 6, 7), (3, 2, 3)
    x = rng.standard_normal((b, *sp, ci)).astype(np.float32)
    ws = [(rng.random((2, ci, co, *modes)) / (ci * co)).astype(np.float32)
          for _ in range(4)]
    dy = rng.standard_normal((b, *sp, co)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref, vjp = jax.vjp(lambda x, ws: jax_spectral(x, ws, modes),
                           jnp.asarray(x), [jnp.asarray(w) for w in ws])
        g_x, g_ws = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).movedim(-1, 1).requires_grad_()
    wt = [torch.from_numpy(w).requires_grad_() for w in ws]
    out = spectral_conv_nd(xt, wt, modes)
    (out * torch.from_numpy(dy).movedim(-1, 1)).sum().backward()
    assert out.dtype == torch.float32
    assert _rel(out.detach().movedim(1, -1).numpy(), ref) < REL_FWD
    assert _rel(xt.grad.movedim(1, -1).numpy(), g_x) < REL_GRAD
    for w, g in zip(wt, g_ws):
        assert _rel(w.grad.numpy(), g) < REL_GRAD


def _model_cfg(name):
    base = dict(num_c=1, num_spatial_dims=3, time_window=TW,
                data_structure="grid", processor_residual=False,
                encoder="enc_grid.ElementWise", hidden_features=16,
                decoder="dec_grid.TimeConvDense", dec_delta_mode="per_step",
                activation="gelu")
    if name == "fno":
        return dict(base, processor="FNO", fno_modes=2, hidden_blocks=2,
                    fno_kernel_size=1, fno_conv_mode="single")
    return dict(base, processor="DilatedResnet", kernel_size=3,
                hidden_blocks=1, padding_mode="circular", dec_kernel_size=3,
                dec_padding_mode="circular")


def _inputs(nx, b=2, seed=0):
    rng = np.random.default_rng(seed)
    u = (rng.random((b, 1, TW) + nx) + 0.5).astype(np.float32)
    cond = rng.random((b, N_STATIC)).astype(np.float32)
    pos = np.broadcast_to(JaxPDE3D(**_pde_kw(nx)).x.astype(np.float32)[None],
                          (b,) + nx + (3,)).copy()
    return u, cond, pos


def _pair(name):
    """Both 3D models, JAX's weights in the port, and their inputs."""
    nx = NX[name]
    cfg = _model_cfg(name)
    jmodel = jm.EncProcDec(pde=JaxPDE3D(**_pde_kw(nx)), **cfg)
    tmodel = EncProcDec(pde=PDE3D(**_pde_kw(nx)), **cfg)
    u, cond, pos = _inputs(nx)
    params = _np(jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0), u,
                                             cond=cond, pos=pos))())
    tmodel.load_state_dict(from_jax_params(params), strict=True)
    return jmodel, tmodel, params, (u, cond, pos)


@pytest.mark.parametrize("name", ["fno", "drn"])
def test_forward_and_gradients_3d(name):
    """The 3D EncProcDec (counterpart of ``test_forward_parity_3d``):
    output, every parameter's gradient, and convert_state_dict of the port's
    weights, the JAX tree again bit for bit (the spectral weights1..4, the
    Conv3d kernels)."""
    jmodel, tmodel, params, (u, cond, pos) = _pair(name)
    dy = np.random.default_rng(1).standard_normal(u.shape).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref, vjp = jax.vjp(lambda p: jmodel.apply(p, u, cond=cond, pos=pos),
                           params)
        (grads,) = vjp(jnp.asarray(dy))
    out = tmodel(torch.from_numpy(u), cond=torch.from_numpy(cond),
                 pos=torch.from_numpy(pos))
    (out * torch.from_numpy(dy)).sum().backward()
    assert out.shape == ref.shape
    assert _rel(out.detach().numpy(), ref) < REL_FWD
    ref_g = from_jax_params(_np(grads))
    for k, p in tmodel.named_parameters():
        assert _rel(p.grad.numpy(), ref_g[k].numpy()) < REL_GRAD, k
    if name == "fno":
        assert {k.rsplit(".", 1)[1] for k in tmodel.state_dict()
                if ".conv.weights" in k} == {"weights1", "weights2",
                                             "weights3", "weights4"}
    back = convert_state_dict(tmodel.state_dict())["params"]
    flat = jax.tree_util.tree_flatten_with_path(back)[0]
    ref_flat = dict(jax.tree_util.tree_flatten_with_path(
        params["params"])[0])
    assert len(flat) == len(ref_flat)
    for path, v in flat:
        np.testing.assert_array_equal(v, ref_flat[path],
                                      err_msg=jax.tree_util.keystr(path))


def test_grad_step_3d_fno():
    """A 3D FNO grad step (counterpart of ``test_grad_step_3d_fno``): the
    loss sqrt(sum (pred - labels)^2) and its gradients against
    jax.value_and_grad, all finite, some non-zero."""
    jmodel, tmodel, params, (u, cond, pos) = _pair("fno")
    labels = np.roll(u, -1, axis=2)

    def loss_fn(p):
        pred = jmodel.apply(p, u, cond=cond, pos=pos)
        return jnp.sqrt(jnp.sum((pred - labels) ** 2))

    with jax.default_matmul_precision("highest"):
        loss_ref, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    pred = tmodel(torch.from_numpy(u), cond=torch.from_numpy(cond),
                  pos=torch.from_numpy(pos))
    loss = torch.sqrt(torch.sum((pred - torch.from_numpy(labels)) ** 2))
    loss.backward()
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=REL_LOSS)
    ref_g = from_jax_params(_np(grads))
    got = {k: p.grad.numpy() for k, p in tmodel.named_parameters()}
    assert all(np.isfinite(g).all() for g in got.values())
    assert any(np.abs(g).max() > 0 for g in got.values())
    for k, g in got.items():
        assert _rel(g, ref_g[k].numpy()) < REL_GRAD, k


def test_moe_3d_forward_and_gradients():
    """The 3D mixture of spectral experts (2 blocks x 2 experts, its gate on
    the static conditioning; the expert-parallel cases hold it split):
    output and every parameter's gradient against jax.vjp, JAX's stacked
    experts split by ``from_jax_params``."""
    nx = NX["fno"]
    cfg = dict(_model_cfg("fno"), processor="MoEFNO", n_experts=2)
    jmodel = jm.EncProcDec(pde=JaxPDE3D(**_pde_kw(nx)), **cfg)
    tmodel = EncProcDec(pde=PDE3D(**_pde_kw(nx)), **cfg)
    u, cond, pos = _inputs(nx)
    params = _np(jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0), u,
                                             cond=cond, pos=pos))())
    tmodel.load_state_dict(from_jax_params(params), strict=True)
    assert any(".experts.1.1.conv.weights4" in k
               for k in tmodel.state_dict())
    dy = np.random.default_rng(2).standard_normal(u.shape).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref, vjp = jax.vjp(lambda p: jmodel.apply(p, u, cond=cond, pos=pos),
                           params)
        (grads,) = vjp(jnp.asarray(dy))
    out = tmodel(torch.from_numpy(u), cond=torch.from_numpy(cond),
                 pos=torch.from_numpy(pos))
    (out * torch.from_numpy(dy)).sum().backward()
    assert out.shape == ref.shape
    assert _rel(out.detach().numpy(), ref) < REL_FWD
    ref_g = from_jax_params(_np(grads))
    for k, p in tmodel.named_parameters():
        assert _rel(p.grad.numpy(), ref_g[k].numpy()) < REL_GRAD, k


def test_film_in_3d_raises_as_in_jax():
    x = np.zeros((1, 8, 6, 6, 4), np.float32)
    p = np.zeros((1, 2), np.float32)
    jlayer = jfno.SpectralConvND(in_channels=4, out_channels=4,
                                 modes=(2, 2, 2), num_spatial_dims=3,
                                 feature_transform=True,
                                 feature_transform_dim=2)
    with pytest.raises(NotImplementedError):
        jlayer.init(jax.random.PRNGKey(0), x, p)
    with pytest.raises(NotImplementedError, match="FiLM"):
        tfno.SpectralConvND(4, 4, (2, 2, 2), 3, feature_transform=True,
                            feature_transform_dim=2)
    with pytest.raises(NotImplementedError, match="FiLM"):
        tfno.FNO(num_spatial_dims=3, n_cond=2, hidden_features=4,
                 fno_modes=2, hidden_blocks=1, cond_mode="film")


@pytest.mark.parametrize("nd", [1, 2, 3])
@pytest.mark.parametrize("mix_impl", ["dft", "xla", "pallas"])
def test_mix_impl_values_match_jax(nd, mix_impl):
    """An FNO layer whose spec sets each mix_impl value (the port reads the
    field where the spec is read, and has one route): JAX's output at that
    value (its truncated-DFT or FFT route), in 1D, 2D and 3D."""
    sp = {1: (16,), 2: (12, 10), 3: (8, 6, 6)}[nd]
    rng = np.random.default_rng(nd)
    x = rng.standard_normal((2, *sp, 5)).astype(np.float32)
    kw = dict(hidden_dim=5, hidden_dim_out=4, num_spatial_dims=nd, modes=2,
              mix_impl=mix_impl)
    jlayer = jfno.FNO_Layer(**kw)
    with jax.default_matmul_precision("highest"):
        ref, params = jax.jit(jlayer.init_with_output)(jax.random.PRNGKey(1),
                                                       x)
    layer = create_model("fno.FNO_Layer", None, kw)
    assert isinstance(layer, tfno.FNO_Layer)
    layer.load_state_dict(from_jax_params(_np(params)), strict=True)
    with torch.no_grad():
        out = layer(torch.from_numpy(x).movedim(-1, 1)).movedim(1, -1)
    assert _rel(out.numpy(), ref) < REL_FWD


@pytest.mark.parametrize("where", ["base_args", "processor_spec"])
def test_unknown_mix_impl_raises(where):
    """The port refuses a mix_impl outside the three, set in a model's base
    args or in its processor's spec, for every processor with spectral
    convs; the JAX package does not check it and runs its FFT route."""
    x = np.random.default_rng(0).standard_normal((1, 12, 10, 3)).astype(
        np.float32)
    jlayer = jfno.FNO_Layer(hidden_dim=3, num_spatial_dims=2, modes=2,
                            mix_impl="cufft")
    with jax.default_matmul_precision("highest"):
        got, params = jax.jit(jlayer.init_with_output)(
            jax.random.PRNGKey(0), x)
        ref = jfno.FNO_Layer(hidden_dim=3, num_spatial_dims=2, modes=2,
                             mix_impl="xla").apply(params, x)
    assert _rel(got, ref) < REL_FWD
    pde = PDE2D(tmin=0.0, tmax=1.0, nt=11, L1=1.0, L2=1.0, nx1=12, nx2=10,
                x=None, name="box")
    base = dict(num_c=1, num_spatial_dims=2, time_window=2,
                encoder="enc_grid.ElementWise",
                decoder="dec_grid.TimeConvDense",
                hidden_features=4, fno_modes=2, hidden_blocks=1, n_experts=2)
    for processor in ("FNO", "UFNO", "MoEFNO"):
        if where == "base_args":
            kw = dict(base, processor=processor, mix_impl="cufft")
        else:
            kw = dict(base, processor=dict(object=processor,
                                           mix_impl="cufft"))
        with pytest.raises(ValueError, match="mix_impl"):
            EncProcDec(pde=pde, **kw)
        kw = (dict(kw, mix_impl="xla") if where == "base_args" else
              dict(kw, processor=dict(object=processor, mix_impl="xla")))
        EncProcDec(pde=pde, **kw)
