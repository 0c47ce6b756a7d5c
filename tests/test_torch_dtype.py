"""The port's compute-dtype switch against ``nps_tpu``'s: the spellings
``set_compute_dtype`` takes, each module that casts to the compute dtype,
the spectral conv at m2 = 20 (the shape class of the large-plane kernel
variant), one serving step of four twophase families (the MoE among them)
and of the MP-GNN in bf16.

Inputs are made with numpy from a seed; the port's weights are carried
into the JAX modules (``convert_state_dict``'s layouts), so both sides
compute the same function. JAX runs at precision "highest", PyTorch with
TF32 off (the CPU has none).

Bars: in f32, forward max|d| / max|ref| < 1e-4 (ROADMAP "How a part is
held"). In bf16 the two packages round at different places (JAX rounds
every einsum and elementwise op to bf16; the port's kernels and plain
versions sum in f32 and round once), so the bar says that the port rounds
no worse than the reference's own bf16 does: with
d_jax = max|JAX_bf16 - JAX_f32| / max|JAX_f32|, the port in bf16 against
JAX in bf16 satisfies max|d| / max|JAX_f32| <= max(2 d_jax, 8e-3). Output
dtypes match JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nps_tpu.inference import SurrogateEngine as JaxEngine
from nps_tpu.models import common as jcommon
from nps_tpu.models import config as jconfig
from nps_tpu.models.activations import GELU as JaxGELU
from nps_tpu.ops import spectral as jspectral
from nps_tpu.pde import PDE2D as JaxPDE2D
from nps_tpu_torch.inference import SurrogateEngine
from nps_tpu_torch.models import common as tcommon
from nps_tpu_torch.models import config as tconfig
from nps_tpu_torch.models.fno import SpectralConvND
from nps_tpu_torch.ops import group_norm as tgn
from nps_tpu_torch.ops import spectral as tsp
from nps_tpu_torch.pde import PDE2D

REL_FWD, BF16_FLOOR = 1e-4, 8e-3
BF16 = "bfloat16"


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


def _np(t):
    return t.detach().float().numpy()


def _bf16_bar(port_bf16, jax_bf16, jax_f32):
    """(error, bar) of the port in bf16 against JAX in bf16, both relative
    to max|JAX_f32|."""
    scale = np.abs(jax_f32).max()
    d_jax = np.abs(jax_bf16 - jax_f32).max() / scale
    err = np.abs(port_bf16 - jax_bf16).max() / scale
    return float(err), float(max(2 * d_jax, BF16_FLOOR))


# ---- the switch ----------------------------------------------------------

@pytest.mark.parametrize("spelling", [None, "float32", "f32", "bfloat16",
                                      "bf16"])
def test_set_compute_dtype_accepts_the_jax_spellings(spelling):
    jconfig.set_compute_dtype(spelling)
    tconfig.set_compute_dtype(spelling)
    j, t = jconfig.compute_dtype(), tconfig.compute_dtype()
    assert (j is None) == (t is None)
    if j is not None:
        assert jnp.dtype(j).name == "bfloat16" and t == torch.bfloat16
    with tconfig.compute_dtype_scope(None):
        assert tconfig.compute_dtype() is None
    assert tconfig.compute_dtype() is t


@pytest.mark.parametrize("spelling", ["float16", "fp32", "bfloat", "int8"])
def test_set_compute_dtype_refuses_what_jax_refuses(spelling):
    with pytest.raises(ValueError):
        jconfig.set_compute_dtype(spelling)
    with pytest.raises(ValueError):
        tconfig.set_compute_dtype(spelling)


# ---- the modules ---------------------------------------------------------

def _seeded(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return module


def _conv():
    t = _seeded(tcommon.ConvND(6, 5, 3, 2, padding="same",
                               padding_mode="circular"), 1)
    j = jcommon.ConvND(5, 3, 2, padding="same", padding_mode="circular")
    params = {"kernel": _np(t.weight).transpose(2, 3, 1, 0),
              "bias": _np(t.bias)}
    return t, lambda x: j.apply({"params": params}, x), (2, 12, 10, 6)


def _conv_transpose():
    t = _seeded(tcommon.ConvTransposeND(6, 5, 4, 2, strides=2, pre_pad=1), 2)
    j = jcommon.ConvTransposeND(5, 4, 2, strides=2, pre_pad=1)
    params = {"kernel": _np(t.weight).transpose(2, 3, 0, 1),
              "bias": _np(t.bias)}
    return t, lambda x: j.apply({"params": params}, x), (2, 7, 6, 6)


def _dense():
    t = _seeded(tcommon.Dense(6, 5), 3)
    j = jcommon.Dense(5)
    params = {"kernel": _np(t.weight).T, "bias": _np(t.bias)}
    return t, lambda x: j.apply({"params": params}, x), (2, 7, 6)


def _group_norm():
    t = _seeded(tcommon.GroupNorm(2, 6), 4)
    j = jcommon.GroupNormFast(num_groups=2)
    params = {"scale": _np(t.weight), "bias": _np(t.bias)}
    return t, lambda x: j.apply({"params": params}, x), (2, 9, 7, 6)


def _gn_gelu():
    t = _seeded(tcommon.GroupNorm(1, 6), 5)
    j = jcommon.GroupNormFast(num_groups=1)
    params = {"scale": _np(t.weight), "bias": _np(t.bias)}
    return ((lambda x: t.with_gelu(x)),
            lambda x: JaxGELU()(j.apply({"params": params}, x)), (2, 9, 7, 6))


def _spectral(modes=(4, 3), shape=(2, 12, 10, 6)):
    t = SpectralConvND(6, 5, modes, 2)
    t.reset_parameters(torch.Generator().manual_seed(6))
    ws = [_np(t.weights1), _np(t.weights2)]

    def ref(x):
        with jax.default_matmul_precision("highest"):
            return jspectral.spectral_conv_nd(x, ws, modes, precision="highest")
    return t, ref, shape


MODULES = {"conv_circular": _conv, "conv_transpose": _conv_transpose,
           "dense": _dense, "group_norm": _group_norm, "gn_gelu": _gn_gelu,
           "spectral_conv_nd": _spectral}


def _run(port, ref, x, dtype):
    """(port output, JAX output) for the channels-last input ``x`` under
    compute dtype ``dtype`` (bf16: the input in bf16 too, as activations
    are there), both as numpy f32, with the output dtypes."""
    jconfig.set_compute_dtype(dtype)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype else jnp.float32)
    j = ref(jx)
    tx = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
    if x.ndim == 3:   # Dense: features last on both sides
        tx = torch.from_numpy(x)
    with tconfig.compute_dtype_scope(dtype), torch.no_grad():
        t = port(tx.to(torch.bfloat16 if dtype else torch.float32))
    t_np = _np(t) if x.ndim == 3 else np.moveaxis(_np(t), 1, -1)
    return t_np, np.asarray(j, np.float32), str(t.dtype), str(j.dtype)


@pytest.mark.parametrize("dtype", [None, BF16])
@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name, dtype):
    port, ref, shape = MODULES[name]()
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    out, j, t_dtype, j_dtype = _run(port, ref, x, dtype)
    assert t_dtype.replace("torch.", "") == j_dtype
    _, j32, _, _ = _run(port, ref, x, None)
    if dtype is None:
        assert np.abs(out - j32).max() / np.abs(j32).max() < REL_FWD
    else:
        assert j_dtype == BF16
        err, bar = _bf16_bar(out, j, j32)
        assert err <= bar, (err, bar)


def test_spectral_plain_at_m2_20_matches_jax():
    """m2 = 20 on a 48 x 48 grid (f32): the plain version, the CPU path and
    the tests' reference, in the shape class the large-plane variant takes
    on the card."""
    port, ref, shape = _spectral((20, 20), (2, 48, 48, 6))
    x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    out, j, t_dtype, j_dtype = _run(port, ref, x, None)
    assert t_dtype == "torch.float32" and j_dtype == "float32"
    assert np.abs(out - j).max() / np.abs(j).max() < REL_FWD


def test_spectral_op_in_bf16_passes_opcheck():
    """The custom op's fake gives the real op's bf16 output type, so an
    exported or traced graph carries the right type."""
    g = torch.Generator().manual_seed(9)
    x = torch.randn(2, 5, 12, 10, generator=g).to(torch.bfloat16)
    ws = [torch.rand((2, 5, 3, 3, 4), generator=g) / 15 for _ in range(2)]
    wp = tsp.pack_weights_2d(ws)
    y = torch.ops.nps_torch.spectral_dft2d_fwd(x, wp, 3, 4, None, 1)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y, tsp.spectral_conv_2d_plain(x, ws, (3, 4)),
                               rtol=0, atol=0)
    torch.library.opcheck(torch.ops.nps_torch.spectral_dft2d_fwd.default,
                          (x, wp, 3, 4, None, 1))
    xg = torch.randn(2, 6, 5, 7, generator=g).to(torch.bfloat16)
    w, b = torch.ones(6), torch.zeros(6)
    assert tgn.gn_gelu(xg, w, b).dtype == torch.bfloat16


# ---- whole families ------------------------------------------------------

NT, NX1, NX2, TW, B = 21, 24, 16, 5, 2
FAMILIES = {
    "drn": ["--model.hidden_features=16", "--model.hidden_blocks=1"],
    "unet": ["--model.hidden_features=8", "--model.ch_mults=[2,1]"],
    "ufno_fno": ["--model.hidden_features=16", "--model.fno_modes=4"],
    "moe": ["--model.hidden_features=16", "--model.hidden_blocks=2",
            "--model.fno_modes=4"],
}
PDE_KW = dict(tmin=0, tmax=10, nt=NT, L1=1.0, L2=0.7, nx1=NX1, nx2=NX2,
              x=None, name="twophase", n_cond_static=2, n_cond_spatial=2)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    u0 = (0.1 + 0.8 * rng.random((B, 1, TW, NX1, NX2))).astype(np.float32)
    cond = rng.random((B, 2)).astype(np.float32)
    sc = (rng.random((B, 2, NX1, NX2)) > 0.8).astype(np.float32)
    return u0, cond, sc


def _jax_step(cfg, over, dtype, u0, cond, sc, params=None):
    """One JAX serving step under ``dtype`` (a fresh engine, so a fresh
    trace); returns (output, params)."""
    jconfig.set_compute_dtype(dtype)
    eng = JaxEngine.from_config(cfg, pde=JaxPDE2D(**PDE_KW), overrides=over)
    with jax.default_matmul_precision("highest"):
        if params is None:
            eng.init_params(u0, cond=cond, spatial_cond=sc, seed=0)
        else:
            eng.params = params
        return eng.step(u0, cond=cond, spatial_cond=sc), eng.params


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_step_in_bf16_matches_jax(family):
    """One serving step of each family built by both engines from their
    configs, JAX weights carried into the port, in bf16 (the bf16 bar) and
    in f32 (1e-4)."""
    over = [f"--time_window={TW}", *FAMILIES[family]]
    u0, cond, sc = _inputs()
    jcfg = f"nps_tpu/configs/train/cfg_twophase_{family}.py"
    tcfg = f"nps_tpu_torch/configs/train/cfg_twophase_{family}.py"
    j32, params = _jax_step(jcfg, over, None, u0, cond, sc)
    jbf, _ = _jax_step(jcfg, over, BF16, u0, cond, sc, params)
    host = jax.tree_util.tree_map(np.asarray, params)
    out = {}
    for dtype in (None, BF16):
        eng = SurrogateEngine.from_config(tcfg, pde=PDE2D(**PDE_KW),
                                          overrides=over, device="cpu",
                                          compute_dtype=dtype)
        eng.load_jax_params(host)
        out[dtype] = eng.step(u0, cond=cond, spatial_cond=sc)
    assert out[BF16].dtype == np.float32   # the physics wrapper is f32
    assert np.abs(out[None] - j32).max() / np.abs(j32).max() < REL_FWD
    err, bar = _bf16_bar(out[BF16], jbf, j32)
    assert err <= bar, (err, bar)


def test_mpgnn_refuses_bf16_naming_its_item():
    """The name is older than the MP-GNN's bf16 casts, which are ported
    now: one serving step of ``cfg_twophase_gnn`` (the shifted-grid path)
    built by both engines, JAX weights carried into the port, in bf16 at
    the bf16 bar, the physics wrapper's output f32."""
    over = ["--time_window=5", "--model.hidden_features=16",
            "--model.hidden_blocks=2"]
    jcfg = "nps_tpu/configs/train/cfg_twophase_gnn.py"
    u0, cond, _ = _inputs()
    j32, params = _jax_step(jcfg, over, None, u0, cond, None)
    jbf, _ = _jax_step(jcfg, over, BF16, u0, cond, None, params)
    eng = SurrogateEngine.from_config(
        "nps_tpu_torch/configs/train/cfg_twophase_gnn.py",
        pde=PDE2D(**PDE_KW), overrides=over, device="cpu",
        compute_dtype="bf16")
    eng.load_jax_params(jax.tree_util.tree_map(np.asarray, params))
    out = eng.step(u0, cond=cond)
    assert out.dtype == np.float32
    err, bar = _bf16_bar(out, jbf, j32)
    assert err <= bar, (err, bar)
