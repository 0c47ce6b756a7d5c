"""The port's CUDA kernels against their plain versions at edge shapes the
main path does not reach (scalar and vector paths, bf16, several rounds of
the persistent GroupNorm grid, a batch above the mix kernel's 8-sample
register tile, channel counts that are not multiples of its tiles, every
unrolled m2 bound, FiLM), and the engine on the card against the engine on
the CPU.

Needs an NVIDIA GPU and nvcc; skips elsewhere. On the GPU machine, which
has no JAX, run it without the repo's conftest:
``python -m pytest --noconftest tests/test_torch_cuda.py``.
Bar: max|d| / max|ref| < 1e-5 in f32 (sums in another order), 1e-2 in bf16
(one rounding of an 8-bit mantissa).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rel(a, ref):
    return float((a.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


@pytest.mark.parametrize("shape", [(3, 5, 7, 9), (2, 8, 8, 8),
                                   (2, 4, 3, 5, 6)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("gelu", [False, True])
def test_gn1_gelu_kernel(shape, dtype, tol, gelu):
    from nps_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(shape, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    c = shape[1]
    w = torch.randn(c, device="cuda", generator=g)
    b = torch.randn(c, device="cuda", generator=g)
    y = gn.gn1_gelu_fwd(x, w, b, gelu)
    assert y.dtype == dtype
    assert _rel(y, gn.gn_gelu_plain(x, w, b, gelu)) < tol


# (shape, rounds of the persistent grid in f32 on an H100): one sample, the
# main path's largest shape (two rounds of two samples), b=5 (three rounds
# of two and one), a sample that takes the whole grid (two rounds of one),
# the whole batch in one round at b=5, channels that change inside a
# 16-byte vector (hw % 4 != 0, hw < 4)
@pytest.mark.parametrize("shape,rounds", [
    ((1, 388, 100, 68), 1),
    ((4, 388, 100, 68), 2),
    ((5, 388, 100, 68), 3),
    ((2, 1024, 100, 68), 2),
    ((5, 200, 100, 68), 1),
    ((2, 4, 7, 9), 1),
    ((2, 8, 1, 3), 1),
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_gn1_gelu_kernel_persistent_rounds(shape, rounds, dtype, tol):
    from nps_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device="cuda").manual_seed(2)
    x = (torch.randn(shape, device="cuda", generator=g) * 1.5 + 0.3).to(dtype)
    c = shape[1]
    w = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=g)
    b = 0.1 * torch.randn(c, device="cuda", generator=g)
    y = gn.gn1_gelu_fwd(x, w, b)
    assert _rel(y, gn.gn_gelu_plain(x, w, b)) < tol
    if dtype == torch.float32:
        assert gn._plan(shape[0], x[0].numel(), False)[4] == rounds


def test_gn1_gelu_kernel_second_call_matches_first():
    """No barrier state outlives a call: a second call, and calls at other
    shapes and round counts in between, give the same bits."""
    from nps_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((4, 192, 47, 31), device="cuda", generator=g)
    w = torch.randn(192, device="cuda", generator=g)
    b = torch.randn(192, device="cuda", generator=g)
    first = gn.gn1_gelu_fwd(x, w, b)
    gn.gn1_gelu_fwd(torch.randn((2, 192, 100, 68), device="cuda"), w, b)
    gn.gn1_gelu_fwd(torch.randn((6, 192, 100, 68), device="cuda"), w, b)
    second = gn.gn1_gelu_fwd(x, w, b)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert _rel(second, gn.gn_gelu_plain(x, w, b)) < 1e-5


def test_gn1_gelu_kernel_refuses_bad_input():
    from nps_tpu_torch.ops import group_norm as gn

    x = torch.randn(2, 4, 6, 6, device="cuda")
    w, b = torch.ones(4, device="cuda"), torch.zeros(4, device="cuda")
    with pytest.raises(ValueError):
        gn.gn1_gelu_fwd(x.transpose(2, 3), w, b)
    with pytest.raises(TypeError):
        gn.gn1_gelu_fwd(x.double(), w, b)
    with pytest.raises(ValueError):
        gn.gn1_gelu_fwd(x, w[:3], b)
    # one f32 sample of 55.7 MB: more than the resident grid's shared memory
    big = torch.zeros((1, 2048, 100, 68), device="cuda")
    w, b = torch.ones(2048, device="cuda"), torch.zeros(2048, device="cuda")
    with pytest.raises(ValueError, match="does not fit"):
        gn.gn1_gelu_fwd(big, w, b)


@pytest.mark.parametrize("b,ci,co,grid,modes", [
    (10, 5, 130, (16, 12), (4, 4)),     # b above the 8-sample tile
    (3, 7, 6, (12, 10), (3, 6)),        # Nyquist column kept
    (4, 198, 200, (96, 64), (10, 10)),  # co, ci not multiples of the tiles
    (5, 13, 64, (32, 20), (8, 10)),
    (1, 9, 70, (20, 18), (5, 9)),       # scalar rows and weights, b=1
    (2, 4, 8, (32, 32), (4, 16)),       # the largest m2 bound
])
@pytest.mark.parametrize("film_mode", [None, 0, 1])
def test_spectral_kernel(b, ci, co, grid, modes, film_mode):
    from nps_tpu_torch.ops import spectral as sp

    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((b, ci) + grid, device="cuda", generator=g)
    ws = [torch.rand((2, ci, co) + modes, device="cuda", generator=g)
          for _ in range(2)]
    film = (None if film_mode is None else
            torch.randn((b, co, 2 * modes[0], modes[1]), device="cuda",
                        generator=g))
    fm = 1 if film_mode is None else film_mode
    y = sp.spectral_conv_nd(x, ws, modes, film=film, film_mode=fm)
    ref = sp.spectral_conv_2d_plain(x, ws, modes, film, fm)
    assert _rel(y, ref) < 1e-5


def test_engine_on_card_matches_cpu():
    from nps_tpu_torch import kernels
    from nps_tpu_torch.inference import SurrogateEngine
    from nps_tpu_torch.pde import PDE2D

    cfg = "nps_tpu_torch/configs/train/cfg_twophase_ufno.py"
    pde = PDE2D(tmin=0, tmax=10, nt=51, L1=1.0, L2=0.7, nx1=24, nx2=16,
                x=None, name="twophase", n_cond_static=2, n_cond_spatial=2)
    over = ["--model.hidden_features=16", "--model.hidden_blocks=2",
            "--model.fno_modes=4", "--time_window=5"]
    gpu = SurrogateEngine.from_config(cfg, pde=pde, overrides=over)
    cpu = SurrogateEngine.from_config(cfg, pde=pde, overrides=over,
                                      device="cpu")
    gpu.init_params(seed=0)
    cpu.init_params(seed=0)
    rng = np.random.default_rng(0)
    u0 = (0.1 + 0.8 * rng.random((2, 1, 5, 24, 16))).astype(np.float32)
    cond = rng.random((2, 2)).astype(np.float32)
    sc = (rng.random((2, 2, 24, 16)) > 0.8).astype(np.float32)
    kernels.reset_launches()
    out = gpu.rollout(u0, 3, cond=cond, spatial_cond=sc)
    assert dict(kernels.launches) == {"gn1_gelu_fwd": 3 * 2 * 16,
                                      "spectral_dft2d_fwd": 3 * 2}
    ref = cpu.rollout(u0, 3, cond=cond, spatial_cond=sc)
    nrmse = np.sqrt(np.mean((out - ref) ** 2) / np.mean(ref ** 2))
    assert nrmse < 1e-3


def test_gn1_gelu_kernel_constant_sample_clamps_variance():
    """f32 E[x^2] - E[x]^2 of a constant 777.7 rounds below 0; the kernel
    clamps it as the plain version does instead of returning NaN."""
    from nps_tpu_torch.ops import group_norm as gn

    x = torch.full((2, 8, 12, 10), 777.7, device="cuda")
    w = torch.ones(8, device="cuda")
    b = torch.linspace(-1.0, 1.0, 8, device="cuda")
    y = gn.gn1_gelu_fwd(x, w, b)
    ref = torch.nn.functional.gelu(b.reshape(1, 8, 1, 1).expand_as(x))
    assert torch.isfinite(y).all()
    assert float((y - ref).abs().max()) < 0.05


# ---- gradients: GNGeluFn and SpectralConv2dFn (bar 1e-4, f32) ---------------
def _grads(fn, inputs, dy):
    inputs = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*inputs)
    return (out, *torch.autograd.grad(out, inputs, dy))


@pytest.mark.parametrize("shape", [(4, 388, 100, 68), (16, 388, 100, 68),
                                   (16, 192, 47, 31), (3, 5, 7, 9)])
@pytest.mark.parametrize("gelu", [True, False])
def test_gn_gelu_fn_gradient_matches_plain_autograd(shape, gelu):
    from nps_tpu_torch import kernels
    from nps_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device="cuda").manual_seed(4)
    c = shape[1]
    x = torch.randn(shape, device="cuda", generator=g) * 1.5 + 0.3
    w = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=g)
    b = 0.1 * torch.randn(c, device="cuda", generator=g)
    dy = torch.randn(shape, device="cuda", generator=g)
    kernels.reset_launches()
    got = _grads(lambda *t: gn.GNGeluFn.apply(*t, gelu, gn.EPS), (x, w, b), dy)
    assert dict(kernels.launches) == {"gn1_gelu_fwd": 1, "gn1_gelu_bwd": 1}
    ref = _grads(lambda *t: gn.gn_gelu_plain(*t, gelu), (x, w, b), dy)
    for a, r, name in zip(got, ref, ("y", "dx", "dgamma", "dbeta")):
        assert _rel(a, r) < 1e-4, name


def test_gn_gelu_bwd_is_deterministic():
    from nps_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((4, 192, 47, 31), device="cuda", generator=g)
    w = torch.randn(192, device="cuda", generator=g)
    b = torch.randn(192, device="cuda", generator=g)
    dy = torch.randn_like(x)
    _, stats = gn.gn1_gelu_fwd_stats(x, w, b)
    first = gn.gn1_gelu_bwd(x, w, b, stats, dy)
    second = gn.gn1_gelu_bwd(x, w, b, stats, dy)
    assert all(torch.equal(a, c) for a, c in zip(first, second))


@pytest.mark.parametrize("b,ci,co,grid,modes", [
    (4, 196, 192, (96, 64), (10, 10)),  # the serving path
    (16, 196, 192, (96, 64), (10, 10)),  # the train step: two batch tiles
    (3, 7, 6, (12, 10), (3, 6)),        # the Nyquist column kept
    (2, 9, 70, (20, 18), (5, 9)),       # scalar rows
])
def test_spectral_fn_gradient_matches_plain_autograd(b, ci, co, grid, modes):
    from nps_tpu_torch import kernels
    from nps_tpu_torch.ops import spectral as sp

    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((b, ci) + grid, device="cuda", generator=g)
    ws = [torch.rand((2, ci, co) + modes, device="cuda", generator=g)
          / (ci * co) for _ in range(2)]
    dy = torch.randn((b, co) + grid, device="cuda", generator=g)
    kernels.reset_launches()
    got = _grads(lambda *t: sp.SpectralConv2dFn.apply(*t, modes),
                 (x, *ws), dy)
    assert dict(kernels.launches) == {"spectral_dft2d_fwd": 1,
                                      "spectral_dft2d_bwd": 1,
                                      "spectral_dw2d": 1}
    ref = _grads(lambda x, w1, w2: sp.spectral_conv_2d_plain(x, [w1, w2],
                                                             modes),
                 (x, *ws), dy)
    for a, r, name in zip(got, ref, ("y", "dx", "dw1", "dw2")):
        assert _rel(a, r) < 1e-4, name


@pytest.mark.parametrize("b,ci,co,grid,modes", [
    (16, 196, 192, (96, 64), (10, 10)),  # the train step
    (10, 5, 130, (16, 12), (4, 4)),     # b above the 8-sample tile, co % 4 != 0
    (3, 7, 6, (12, 10), (3, 6)),        # Nyquist column kept
    (4, 198, 200, (96, 64), (10, 10)),  # ci, co not multiples of the tiles
    (2, 9, 70, (20, 18), (5, 9)),       # scalar rows
    (1, 4, 8, (32, 32), (4, 16)),       # the largest m2 bound, b=1
])
def test_spectral_bwd_kernel_matches_plain(b, ci, co, grid, modes):
    """The adjoint launch on the forward's pack against its plain version:
    dx and dy's spectrum G; a second call gives the same bits."""
    from nps_tpu_torch.ops import spectral as sp

    g = torch.Generator(device="cuda").manual_seed(7)
    dy = torch.randn((b, co) + grid, device="cuda", generator=g)
    ws = [torch.rand((2, ci, co) + modes, device="cuda", generator=g)
          for _ in range(2)]
    packed = sp.pack_weights_2d(ws)
    got = sp.spectral_dft2d_bwd(dy, packed, modes)
    ref = sp.spectral_dft2d_bwd_plain(dy, packed, modes)
    for a, r, name in zip(got, ref, ("dx", "gr", "gi")):
        assert a.shape == r.shape, name
        assert _rel(a, r) < 1e-5, name
    again = sp.spectral_dft2d_bwd(dy, packed, modes)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("ci,co,modes", [
    (5, 7, (3, 4)),        # odd channels: scalar loads, partial tiles
    (196, 192, (10, 10)),  # the train step: 196 -> 192, 20 mode chunks
    (12, 72, (3, 7)),      # 16-byte loads, partial tiles, 21 modes: a
                           # partial mode chunk
])
def test_spectral_dw2d_matches_plain(b, ci, co, modes):
    """spectral_dw2d against spectral_weight_grad on the same spectra; a
    second call gives the same bits (fixed-order sums, no atomics)."""
    from nps_tpu_torch import kernels
    from nps_tpu_torch.ops import spectral as sp

    m1, m2 = modes
    g = torch.Generator(device="cuda").manual_seed(8)
    nm = 2 * m1 * m2
    xr, xi = (torch.randn((nm, b, ci), device="cuda", generator=g)
              for _ in range(2))
    gr, gi = (torch.randn((nm, b, co), device="cuda", generator=g)
              for _ in range(2))
    scale = sp.mode_scale(2 * m1 + 2, 2 * m2, m1, m2, "cuda")
    kernels.reset_launches()
    got = sp.spectral_dw2d(xr, xi, gr, gi, scale, m1)
    assert dict(kernels.launches) == {"spectral_dw2d": 1}
    ref = sp.spectral_weight_grad(xr, xi, gr, gi, scale, m1)
    for a, r, name in zip(got, ref, ("dw1", "dw2")):
        assert a.shape == r.shape == (2, ci, co, m1, m2), name
        assert _rel(a, r) < 1e-5, name
    again = sp.spectral_dw2d(xr, xi, gr, gi, scale, m1)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("fused", [False, True])
def test_spectral_layer_after_adam_step_uses_new_weights(fused):
    """The weights packed for a block of no-grad calls are the weights
    after an optimizer step."""
    from nps_tpu_torch.models.fno import (SpectralConvND,
                                          packed_spectral_weights)
    from nps_tpu_torch.ops import spectral as sp

    torch.manual_seed(0)
    layer = SpectralConvND(196, 192, (10, 10), 2).cuda()
    x = torch.randn((2, 196, 96, 64), device="cuda")
    with torch.no_grad(), packed_spectral_weights(layer):
        layer(x)
    opt = torch.optim.Adam(layer.parameters(), lr=1e-2, fused=fused)
    layer(x).square().mean().backward()
    opt.step()
    with torch.inference_mode(), packed_spectral_weights(layer):
        out = layer(x)
        ref = sp.spectral_conv_2d_plain(x, [layer.weights1, layer.weights2],
                                        (10, 10))
    assert _rel(out, ref) < 1e-5


def test_kernel_outputs_carry_gradients_in_a_model():
    """GN and spectral outputs reach the loss only through the kernels; a
    backward must still give their parameters nonzero gradients."""
    from nps_tpu_torch.models.common import GroupNorm
    from nps_tpu_torch.models.fno import SpectralConvND

    torch.manual_seed(1)
    spec = SpectralConvND(8, 8, (4, 4), 2).cuda()
    norm = GroupNorm(1, 8).cuda()
    x = torch.randn((2, 8, 24, 16), device="cuda")
    loss = norm.with_gelu(spec(x)).square().sum()
    loss.backward()
    for name, p in (("weights1", spec.weights1), ("weights2", spec.weights2),
                    ("gn weight", norm.weight), ("gn bias", norm.bias)):
        assert p.grad is not None and float(p.grad.abs().sum()) > 0, name


def test_film_with_gradients_raises_on_cuda():
    """No silent route to the plain version: FiLM gradients are not ported."""
    from nps_tpu_torch.ops import spectral as sp

    x = torch.randn((2, 4, 12, 10), device="cuda", requires_grad=True)
    ws = [torch.rand((2, 4, 3, 3, 4), device="cuda") for _ in range(2)]
    film = torch.randn((2, 3, 6, 4), device="cuda")
    with pytest.raises(NotImplementedError, match="FiLM"):
        sp.spectral_conv_nd(x, ws, (3, 4), film=film)
    with torch.no_grad():
        sp.spectral_conv_nd(x, ws, (3, 4), film=film)
