"""The port's CUDA kernels against their plain versions at edge shapes the
main path does not reach (scalar and vector paths, bf16, several rounds of
the persistent GroupNorm grid, a batch above the mix kernel's 8-sample
register tile, channel counts that are not multiples of its tiles, every
unrolled m2 bound, FiLM and its gradient, the U-Net's GroupNorm shapes),
and the engine on the card against the engine on the CPU, for each
twophase family; the kernels' custom ops on the card, the captured rollout
against the eager one (bar 1e-6) for all five families, the exported
artifact on the card, and the GNN's step and train gradients against the
CPU. The variants for shapes the resident kernels do not take (the
large-plane spectral conv, f32 and bf16, and the DFT stages each shape
takes, tensor-core or FMA, by kernel name; the streaming GN+GELU), the
twophase shapes still on the resident kernels, and a bf16 engine on the
card against the CPU. The backward at those shapes: the large-plane input
gradient (f32 and bf16, with and without FiLM) and GN+GELU's backward in
bf16, each against autograd through its plain version and for the same
bits on a second call, and a rematerialized train step against one
without remat. The mixture of experts (a train step card against CPU,
through K1 alone), a pushforward_fast step (its no-grad applies launch K2
with the tanh GELU) and the MP-GNN in bf16 against the CPU at the bf16
bar.

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
    # one f32 sample of 55.7 MB, more than the resident grid's shared memory:
    # refused before the streaming variant existed, now taken by it
    from nps_tpu_torch import kernels

    big = torch.randn((1, 2048, 100, 68), device="cuda")
    w, b = torch.ones(2048, device="cuda"), torch.zeros(2048, device="cuda")
    kernels.reset_launches()
    y = gn.gn1_gelu_fwd(big, w, b)
    assert dict(kernels.launches) == {"gn1_gelu_fwd_stream": 1}
    assert _rel(y, gn.gn_gelu_plain(big, w, b)) < 1e-5


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


@pytest.mark.parametrize("shape", [(4, 192, 47, 31), (16, 396, 100, 68),
                                   (64, 8, 16, 16), (1, 388, 100, 68)])
def test_gn_gelu_bwd_is_deterministic(shape):
    from nps_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(shape, device="cuda", generator=g)
    w = torch.randn(shape[1], device="cuda", generator=g)
    b = torch.randn(shape[1], device="cuda", generator=g)
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


def test_film_with_gradients_runs_on_cuda():
    """FiLM with gradients on CUDA: spectral_conv_nd takes
    SpectralConv2dFn, whose launches give the FiLM gradient, and without
    gradients the forward kernel alone runs. No route to the plain
    version."""
    from nps_tpu_torch import kernels
    from nps_tpu_torch.ops import spectral as sp

    x = torch.randn((2, 4, 12, 10), device="cuda", requires_grad=True)
    ws = [torch.rand((2, 4, 3, 3, 4), device="cuda") for _ in range(2)]
    film = torch.randn((2, 3, 6, 4), device="cuda", requires_grad=True)
    kernels.reset_launches()
    sp.spectral_conv_nd(x, ws, (3, 4), film=film).sum().backward()
    assert dict(kernels.launches) == {"spectral_dft2d_fwd": 1,
                                      "spectral_dft2d_bwd": 1}
    assert film.grad is not None and x.grad is not None
    with torch.no_grad():
        sp.spectral_conv_nd(x, ws, (3, 4), film=film)
    assert kernels.launches["spectral_dft2d_fwd"] == 2


# the FiLM gradient: the train shape, the Nyquist column kept, 2*m1 = n1
# with m2 = n2//2 + 1 on an odd n2 (the per-mode scale is 1/(n1 n2) on
# column 0, 2/(n1 n2) elsewhere), b above the 8-sample tile with b*co not
# a multiple of the 32-pair tile
FILM_CASES = [
    (16, 196, 192, (96, 64), (10, 10)),
    (3, 7, 6, (12, 10), (3, 6)),
    (2, 5, 9, (10, 9), (5, 5)),
    (10, 5, 130, (16, 12), (4, 4)),
]


@pytest.mark.parametrize("film_mode", [0, 1])
@pytest.mark.parametrize("b,ci,co,grid,modes", FILM_CASES)
def test_spectral_fn_film_gradient_matches_plain_autograd(film_mode, b, ci,
                                                          co, grid, modes):
    """SpectralConv2dFn with FiLM: y, dx, dW and dfilm against autograd
    through the plain version (bar 1e-4)."""
    from nps_tpu_torch import kernels
    from nps_tpu_torch.ops import spectral as sp

    m1, m2 = modes
    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((b, ci) + grid, device="cuda", generator=g)
    ws = [torch.rand((2, ci, co) + modes, device="cuda", generator=g)
          / (ci * co) for _ in range(2)]
    film = torch.randn((b, co, 2 * m1, m2), device="cuda", generator=g)
    dy = torch.randn((b, co) + grid, device="cuda", generator=g)
    kernels.reset_launches()
    got = _grads(lambda x, w1, w2, f: sp.SpectralConv2dFn.apply(
        x, w1, w2, modes, f, film_mode), (x, *ws, film), dy)
    assert dict(kernels.launches) == {"spectral_dft2d_fwd": 1,
                                      "spectral_dft2d_bwd": 1,
                                      "spectral_dw2d": 1}
    ref = _grads(lambda x, w1, w2, f: sp.spectral_conv_2d_plain(
        x, [w1, w2], modes, f, film_mode), (x, *ws, film), dy)
    for a, r, name in zip(got, ref, ("y", "dx", "dw1", "dw2", "dfilm")):
        assert a.shape == r.shape, name
        assert _rel(a, r) < 1e-4, name


@pytest.mark.parametrize("film_mode", [0, 1])
@pytest.mark.parametrize("b,ci,co,grid,modes", FILM_CASES)
def test_spectral_bwd_kernel_with_film_matches_plain(film_mode, b, ci, co,
                                                     grid, modes):
    """The input-gradient launch with FiLM against its plain version on the
    forward's pack and pre-FiLM spectrum: dx, G f and dfilm (bar 1e-5); a
    second call gives the same bits."""
    from nps_tpu_torch.ops import spectral as sp

    m1, m2 = modes
    n1, n2 = grid
    g = torch.Generator(device="cuda").manual_seed(10)
    x = torch.randn((b, ci) + grid, device="cuda", generator=g)
    ws = [torch.rand((2, ci, co) + modes, device="cuda", generator=g)
          for _ in range(2)]
    film = torch.randn((b, co, 2 * m1, m2), device="cuda", generator=g)
    dy = torch.randn((b, co) + grid, device="cuda", generator=g)
    packed = sp.pack_weights_2d(ws)
    _, _, _, ur, ui = sp.spectral_dft2d_fwd_spectrum(x, packed, modes, film,
                                                     film_mode, keep_y=True)
    u_ref = sp.spectral_dft2d_fwd_spectrum_plain(x, packed, modes, film,
                                                 film_mode, keep_y=True)[3:]
    assert _rel(ur, u_ref[0]) < 1e-5 and _rel(ui, u_ref[1]) < 1e-5
    scale = sp.mode_scale(n1, n2, m1, m2, "cuda")
    args = (dy, packed, modes, film, film_mode, (ur, ui), scale)
    got = sp.spectral_dft2d_bwd(*args)
    ref = sp.spectral_dft2d_bwd_plain(*args)
    for a, r, name in zip(got, ref, ("dx", "gr", "gi", "dfilm")):
        assert a.shape == r.shape, name
        assert _rel(a, r) < 1e-5, name
    again = sp.spectral_dft2d_bwd(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("film_mode", [0, 1])
@pytest.mark.parametrize("b,ci,co,grid,modes", FILM_CASES[1:3])
def test_spectral_fn_film_without_gradient_matches_plain(film_mode, b, ci,
                                                         co, grid, modes):
    """FiLM that needs no gradient: the forward keeps no pre-FiLM spectrum,
    the input-gradient launch scales G and writes no dfilm, and y, dx and
    dW match autograd through the plain version (bar 1e-4)."""
    from nps_tpu_torch import kernels
    from nps_tpu_torch.ops import spectral as sp

    m1, m2 = modes
    g = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn((b, ci) + grid, device="cuda", generator=g)
    ws = [torch.rand((2, ci, co) + modes, device="cuda", generator=g)
          / (ci * co) for _ in range(2)]
    film = torch.randn((b, co, 2 * m1, m2), device="cuda", generator=g)
    dy = torch.randn((b, co) + grid, device="cuda", generator=g)
    kernels.reset_launches()
    got = _grads(lambda x, w1, w2: sp.SpectralConv2dFn.apply(
        x, w1, w2, modes, film, film_mode), (x, *ws), dy)
    assert dict(kernels.launches) == {"spectral_dft2d_fwd": 1,
                                      "spectral_dft2d_bwd": 1,
                                      "spectral_dw2d": 1}
    ref = _grads(lambda x, w1, w2: sp.spectral_conv_2d_plain(
        x, [w1, w2], modes, film, film_mode), (x, *ws), dy)
    for a, r, name in zip(got, ref, ("y", "dx", "dw1", "dw2")):
        assert _rel(a, r) < 1e-4, name
    packed = sp.pack_weights_2d(ws)
    args = (dy, packed, modes, film, film_mode)
    dx, gr, gi, dfilm = sp.spectral_dft2d_bwd(*args)
    ref = sp.spectral_dft2d_bwd_plain(*args)
    assert dfilm is None and ref[3] is None
    for a, r, name in zip((dx, gr, gi), ref, ("dx", "gr", "gi")):
        assert _rel(a, r) < 1e-5, name


# K2 at the U-Net's shapes (cfg_twophase_unet at batch 16): the largest
# input, a wide one with odd h*w, the tiny 9x5 sample, the 47x31 level
UNET_GN_SHAPES = [(16, 132, 130, 98), (16, 516, 11, 7), (16, 256, 9, 5),
                  (16, 132, 47, 31), (16, 36, 96, 64)]


@pytest.mark.parametrize("shape", UNET_GN_SHAPES)
def test_gn_gelu_fn_at_unet_shapes(shape):
    """GNGeluFn, output and gradients, against autograd through the plain
    version (bar 1e-4)."""
    from nps_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device="cuda").manual_seed(11)
    c = shape[1]
    x = torch.randn(shape, device="cuda", generator=g) * 1.5 + 0.3
    w = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=g)
    b = 0.1 * torch.randn(c, device="cuda", generator=g)
    dy = torch.randn(shape, device="cuda", generator=g)
    got = _grads(lambda *t: gn.GNGeluFn.apply(*t, True, gn.EPS), (x, w, b),
                 dy)
    ref = _grads(lambda *t: gn.gn_gelu_plain(*t, True), (x, w, b), dy)
    for a, r, name in zip(got, ref, ("y", "dx", "dgamma", "dbeta")):
        assert _rel(a, r) < 1e-4, name


# the families at small widths (as tests/test_torch_families.py): the
# kernels each family's serving step launches
FAMILY_OVERRIDES = {
    "drn": (["--model.hidden_features=16", "--model.hidden_blocks=1"], set()),
    "moe": (["--model.hidden_features=16", "--model.hidden_blocks=2",
             "--model.fno_modes=4"], {"spectral_dft2d_fwd"}),
    "unet": (["--model.hidden_features=8", "--model.ch_mults=[2,1]"],
             {"gn1_gelu_fwd"}),
    "ufno_fno": (["--model.hidden_features=16", "--model.fno_modes=4"],
                 {"gn1_gelu_fwd", "spectral_dft2d_fwd"}),
}


@pytest.mark.parametrize("family", sorted(FAMILY_OVERRIDES))
def test_family_engine_on_card_matches_cpu(family):
    """One serving step of each family on the card against the same step
    on the CPU, same weights (bar 1e-4), through the family's kernels."""
    from nps_tpu_torch import kernels
    from nps_tpu_torch.inference import SurrogateEngine
    from nps_tpu_torch.pde import PDE2D

    cfg = f"nps_tpu_torch/configs/train/cfg_twophase_{family}.py"
    over, want = FAMILY_OVERRIDES[family]
    over = over + ["--time_window=5"]
    pde = PDE2D(tmin=0, tmax=10, nt=51, L1=1.0, L2=0.7, nx1=24, nx2=16,
                x=None, name="twophase", n_cond_static=2, n_cond_spatial=2)
    gpu = SurrogateEngine.from_config(cfg, pde=pde, overrides=over)
    cpu = SurrogateEngine.from_config(cfg, pde=pde, overrides=over,
                                      device="cpu")
    gpu.init_params(seed=0)
    cpu.model.load_state_dict({k: v.cpu()
                               for k, v in gpu.model.state_dict().items()})
    rng = np.random.default_rng(1)
    u0 = (0.1 + 0.8 * rng.random((2, 1, 5, 24, 16))).astype(np.float32)
    cond = rng.random((2, 2)).astype(np.float32)
    sc = (rng.random((2, 2, 24, 16)) > 0.8).astype(np.float32)
    kernels.reset_launches()
    out = gpu.step(u0, cond=cond, spatial_cond=sc)
    assert set(kernels.launches) == want
    ref = cpu.step(u0, cond=cond, spatial_cond=sc)
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-4


# ---- the custom ops, the captured rollout, the artifact, the GNN -----------

@pytest.mark.parametrize("gelu", [True, False])
def test_gn_custom_op_on_card_matches_plain(gelu):
    """nps_torch::gn1_gelu_fwd dispatches a CUDA tensor to the kernel."""
    from nps_tpu_torch import kernels
    from nps_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn((2, 36, 24, 16), device="cuda", generator=g) * 1.5 + 0.3
    w = 1.0 + 0.2 * torch.randn(36, device="cuda", generator=g)
    b = 0.1 * torch.randn(36, device="cuda", generator=g)
    kernels.reset_launches()
    y = torch.ops.nps_torch.gn1_gelu_fwd(x, w, b, gelu, gn.EPS)
    assert dict(kernels.launches) == {"gn1_gelu_fwd": 1}
    assert _rel(y, gn.gn_gelu_plain(x, w, b, gelu)) < 1e-5


@pytest.mark.parametrize("film_mode", [None, 0, 1])
def test_spectral_custom_op_on_card_matches_plain(film_mode):
    from nps_tpu_torch import kernels
    from nps_tpu_torch.ops import spectral as sp

    g = torch.Generator(device="cuda").manual_seed(13)
    b, ci, co, modes = 3, 20, 12, (4, 5)
    x = torch.randn((b, ci, 24, 16), device="cuda", generator=g)
    ws = [torch.rand((2, ci, co, *modes), device="cuda", generator=g)
          / (ci * co) for _ in range(2)]
    film = (None if film_mode is None else torch.randn(
        (b, co, 2 * modes[0], modes[1]), device="cuda", generator=g))
    mode = 1 if film_mode is None else film_mode
    kernels.reset_launches()
    y = torch.ops.nps_torch.spectral_dft2d_fwd(x, sp.pack_weights_2d(ws),
                                               *modes, film, mode)
    assert dict(kernels.launches) == {"spectral_dft2d_fwd": 1}
    assert _rel(y, sp.spectral_conv_2d_plain(x, ws, modes, film, mode)) < 1e-5


CAPTURE_FAMILIES = dict(FAMILY_OVERRIDES, ufno=(
    ["--model.hidden_features=16", "--model.hidden_blocks=2",
     "--model.fno_modes=4"], {"gn1_gelu_fwd", "spectral_dft2d_fwd"}),
    gnn=(["--model.hidden_features=16", "--model.hidden_blocks=2"], set()))


def _small_engine(family, device="cuda"):
    from nps_tpu_torch.inference import SurrogateEngine
    from nps_tpu_torch.pde import PDE2D

    cfg = f"nps_tpu_torch/configs/train/cfg_twophase_{family}.py"
    pde = PDE2D(tmin=0, tmax=10, nt=51, L1=1.0, L2=0.7, nx1=24, nx2=16,
                x=None, name="twophase", n_cond_static=2, n_cond_spatial=2)
    eng = SurrogateEngine.from_config(
        cfg, pde=pde, overrides=CAPTURE_FAMILIES[family][0]
        + ["--time_window=5"], device=device)
    eng.init_params(seed=0)
    return eng


def _small_inputs(b=2, seed=1):
    rng = np.random.default_rng(seed)
    u0 = (0.1 + 0.8 * rng.random((b, 1, 5, 24, 16))).astype(np.float32)
    cond = rng.random((b, 2)).astype(np.float32)
    sc = (rng.random((b, 2, 24, 16)) > 0.8).astype(np.float32)
    return u0, cond, sc


@pytest.mark.parametrize("family", sorted(CAPTURE_FAMILIES))
def test_captured_rollout_matches_eager(family):
    """The CUDA-graph rollout against the eager one (bar 1e-6), at its
    capture and at a replay on new inputs; the capture launches each kernel
    of the family once per model apply."""
    import warnings

    from nps_tpu_torch import kernels

    eng = _small_engine(family)
    u0, cond, sc = _small_inputs()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the GNN ignores spatial_cond
        ref = eng.rollout(u0, 3, cond=cond, spatial_cond=sc)
        kernels.reset_launches()
        out = eng.rollout(u0, 3, cond=cond, spatial_cond=sc, captured=True)
        assert set(kernels.launches) == CAPTURE_FAMILIES[family][1]
        assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-6
        u1, c1, s1 = _small_inputs(seed=2)
        ref1 = eng.rollout(u1, 3, cond=c1, spatial_cond=s1)
        kernels.reset_launches()
        out1 = eng.rollout(u1, 3, cond=c1, spatial_cond=s1, captured=True)
    assert not kernels.launches   # a replay makes no Python launch
    assert np.abs(out1 - ref1).max() / np.abs(ref1).max() < 1e-6


def test_artifact_on_card(tmp_path):
    """Export on the card and serve: the engine's rollout (rtol 1e-5, atol
    1e-6), at an unseen batch too, through both kernels."""
    from nps_tpu_torch import kernels
    from nps_tpu_torch.inference import load_exported

    eng = _small_engine("ufno")
    u0, cond, sc = _small_inputs()
    path = str(tmp_path / "a.npst")
    eng.export_rollout(path, 2, u0, cond=cond, spatial_cond=sc)
    art = load_exported(path)
    assert art.meta["device"] == "cuda"
    for b in (2, 3):
        u, c, s = _small_inputs(b=b, seed=b)
        ref = eng.rollout(u, 2, cond=c, spatial_cond=s)
        kernels.reset_launches()
        out = art.rollout(u, cond=c, spatial_cond=s)
        assert dict(kernels.launches) == {"gn1_gelu_fwd": 2 * 2 * 16,
                                          "spectral_dft2d_fwd": 2 * 2}
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="exported on cuda"):
        load_exported(path, device="cpu")


def test_gnn_engine_and_train_step_on_card_match_cpu():
    """The GNN's serving step (shifted path, index_add_ degrees on the
    card) and one depth-1 train step's loss and gradients against the CPU,
    same weights: bars 1e-4 and 5e-3."""
    import warnings

    gpu, cpu = _small_engine("gnn"), _small_engine("gnn", "cpu")
    cpu.model.load_state_dict({k: v.cpu()
                               for k, v in gpu.model.state_dict().items()})
    u0, cond, _ = _small_inputs()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out, ref = gpu.step(u0, cond=cond), cpu.step(u0, cond=cond)
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-4
    losses, grads = [], []
    for eng in (gpu, cpu):
        u = torch.from_numpy(u0).to(eng.device)
        c = torch.from_numpy(cond).to(eng.device)
        eng.model.zero_grad()
        loss = eng._apply(eng._apply(u, c, eng._pos(2), None).detach(), c,
                          eng._pos(2), None).square().mean()
        loss.backward()
        losses.append(float(loss))
        grads.append({k: p.grad.cpu() for k, p in
                      eng.model.named_parameters()})
    assert abs(losses[0] - losses[1]) / abs(losses[1]) < 1e-4
    floor = 1e-5 * max(float(g.abs().max()) for g in grads[1].values())
    for k, g in grads[1].items():
        scale = max(float(g.abs().max()), floor)
        assert float((grads[0][k] - g).abs().max()) / scale < 5e-3, k


# ---- the large-plane spectral conv and the streaming GN+GELU ----------------
# (b, ci, co, grid, modes, the variant that takes it in f32; bf16 always
# takes the large-plane one)
@pytest.mark.parametrize("b,ci,co,grid,modes,f32_variant", [
    (2, 6, 5, (512, 512), (20, 20), "large"),  # the ns512 plane: 2 row tiles
    (3, 5, 7, (300, 200), (20, 17), "large"),  # a partial row tile
    (1, 3, 4, (1024, 1024), (32, 32), "large"),  # largest rows and m2 bound
    (2, 4, 6, (130, 98), (20, 20), "large"),   # n2 % 4 != 0: scalar paths
    (10, 9, 66, (96, 64), (10, 10), "resident"),  # a twophase plane
    (2, 3, 5, (40, 36), (4, 6), "resident"),   # one row tile, m2 <= 12
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("film_mode", [None, 1])
def test_spectral_large_variant_matches_plain(b, ci, co, grid, modes,
                                              f32_variant, dtype, tol,
                                              film_mode):
    from nps_tpu_torch import kernels
    from nps_tpu_torch.ops import spectral as sp

    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((b, ci) + grid, device="cuda", generator=g).to(dtype)
    ws = [torch.rand((2, ci, co) + modes, device="cuda", generator=g)
          / (ci * co) for _ in range(2)]
    film = (None if film_mode is None else
            torch.randn((b, co, 2 * modes[0], modes[1]), device="cuda",
                        generator=g))
    fm = 1 if film_mode is None else film_mode
    variant = sp._check_kernel_fits(b, ci, *grid, *modes,
                                    bf16=dtype == torch.bfloat16, c_out=co)
    kernels.reset_launches()
    y = sp.spectral_dft2d_fwd(x, sp.pack_weights_2d(ws), modes, film, fm)
    torch.cuda.synchronize()
    name = ("spectral_dft2d_fwd" if variant == "resident"
            else "spectral_dft2d_fwd_large")
    assert dict(kernels.launches) == {name: 1}
    assert variant == ("large" if dtype == torch.bfloat16 else f32_variant)
    assert y.dtype == dtype
    assert _rel(y, sp.spectral_conv_2d_plain(x, ws, modes, film, fm)) < tol


def test_spectral_large_variant_same_bits_at_ns512_shape():
    """The ns512 call ([8, 132, 512, 512] -> 128, 20 x 20 modes, bf16): the
    plain version's bar, and two calls give the same bits (the row tiles'
    partial spectra are summed in a fixed order)."""
    from nps_tpu_torch.ops import spectral as sp

    g = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn((8, 132, 512, 512), device="cuda", generator=g)
    ws = [torch.rand((2, 132, 128, 20, 20), device="cuda", generator=g)
          / (132 * 128) for _ in range(2)]
    wp = sp.pack_weights_2d(ws)
    xb = x.to(torch.bfloat16)
    y = sp.spectral_dft2d_fwd(xb, wp, (20, 20))
    again = sp.spectral_dft2d_fwd(xb, wp, (20, 20))
    torch.cuda.synchronize()
    assert torch.equal(y, again)
    assert _rel(y, sp.spectral_conv_2d_plain(xb, ws, (20, 20))) < 1e-2


# (b, ci, co, grid, modes, dtype, x's offset in elements, the DFT stages)
@pytest.mark.parametrize("b,ci,co,grid,modes,dtype,offset,stages", [
    (8, 132, 128, (512, 512), (20, 20), torch.bfloat16, 0, "tensor"),  # ns512
    (2, 6, 5, (512, 512), (20, 20), torch.bfloat16, 0, "tensor"),
    (3, 5, 7, (300, 200), (20, 17), torch.bfloat16, 0, "tensor"),
    (1, 3, 4, (1024, 1024), (32, 32), torch.bfloat16, 0, "tensor"),
    (10, 9, 66, (96, 64), (10, 10), torch.bfloat16, 0, "tensor"),
    (2, 3, 5, (40, 32), (4, 6), torch.bfloat16, 0, "tensor"),
    (2, 4, 6, (130, 98), (20, 20), torch.bfloat16, 0, "fma"),  # 98 points
    (2, 3, 5, (40, 36), (4, 6), torch.bfloat16, 0, "fma"),     # 36 points
    (2, 6, 5, (512, 512), (20, 20), torch.bfloat16, 4, "fma"),  # x off 8 B
    (2, 6, 5, (512, 512), (20, 20), torch.float32, 0, "fma"),
])
def test_large_plane_dft_stages_by_kernel_name(b, ci, co, grid, modes, dtype,
                                               offset, stages):
    """The DFT stage kernels a large-plane forward and input gradient run,
    by name in a torch.profiler record: the tensor-core stages
    (dft_fwd_tc_kernel, dft_inv_tc_kernel) for bf16 rows of a multiple of 8
    points on 16-byte aligned planes, the ns512 call among them, the FMA
    stages (dft_fwd_big_kernel, dft_inv_big_kernel) otherwise, as
    ``large_stages`` mirrors the choice; each against its plain version.
    A record that holds no device kernel at all (the tracer now and then
    keeps only the launches' API calls in a fresh process) is taken again,
    at most 3 times; a record that holds kernels is judged at once."""
    from torch.profiler import ProfilerActivity, profile

    from nps_tpu_torch.ops import spectral as sp
    from nps_tpu_torch.trace_step import _device_events

    g = torch.Generator(device="cuda").manual_seed(13)

    def planes(c):   # contiguous, its data ``offset`` elements in
        t = torch.empty(b * c * grid[0] * grid[1] + offset, dtype=dtype,
                        device="cuda")[offset:].view((b, c) + grid)
        return t.copy_(torch.randn((b, c) + grid, device="cuda",
                                   generator=g))

    x, dy = planes(ci), planes(co)
    ws = [torch.rand((2, ci, co) + modes, device="cuda", generator=g)
          / (ci * co) for _ in range(2)]
    wp = sp.pack_weights_2d(ws)
    for t in (x, dy):
        assert sp.large_stages(dtype, grid[1], t.data_ptr(), 0) == stages
    want = {"tensor": ("dft_fwd_tc_kernel", "dft_inv_tc_kernel"),
            "fma": ("dft_fwd_big_kernel", "dft_inv_big_kernel")}
    for fn, ref in (
            (lambda: sp.spectral_dft2d_fwd(x, wp, modes),
             lambda: sp.spectral_conv_2d_plain(x, ws, modes)),
            (lambda: sp.spectral_dft2d_bwd(dy, wp, modes)[0],
             lambda: sp.spectral_dft2d_bwd_plain(dy, wp, modes)[0])):
        for _ in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = fn()
                torch.cuda.synchronize()
            if _device_events(prof):
                break
        names = " ".join(e.key for e in prof.key_averages())
        assert all(k in names for k in want[stages]), names
        other = want["fma" if stages == "tensor" else "tensor"]
        assert not any(k in names for k in other), names
        tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
        assert _rel(out, ref()) < tol


def test_twophase_shapes_keep_the_resident_kernels():
    """Every spectral and GN+GELU shape of the twophase serving and train
    paths (f32) still takes the resident kernels."""
    from nps_tpu_torch.ops import group_norm as gn
    from nps_tpu_torch.ops import spectral as sp

    for b in (4, 16):
        assert sp._check_kernel_fits(b, 196, 96, 64, 10, 10,
                                     c_out=192) == "resident"
        assert sp._check_kernel_fits(b, 196, 96, 64, 10, 10,
                                     "spectral_dft2d_bwd") == "resident"
    for shape in ((4, 388, 100, 68), (16, 388, 100, 68), (16, 132, 130, 98),
                  (16, 256, 9, 5), (4, 192, 47, 31)):
        assert gn._plan(shape[0], int(np.prod(shape[1:])), False) is not None


@pytest.mark.parametrize("shape,dtype,tol", [
    ((1, 2048, 100, 68), torch.float32, 1e-5),   # 55.7 MB a sample
    ((2, 36, 516, 516), torch.float32, 1e-5),    # the narrow ns512 model's
    ((2, 260, 516, 516), torch.bfloat16, 1e-2),  # ns512's largest norm input
    ((2, 3001, 101, 103), torch.float32, 1e-5),  # odd hw: scalar path
    ((1, 4099, 131, 129), torch.bfloat16, 1e-2),
])
@pytest.mark.parametrize("gelu", [True, False])
def test_gn1_gelu_stream_matches_plain(shape, dtype, tol, gelu):
    from nps_tpu_torch import kernels
    from nps_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device="cuda").manual_seed(9)
    x = (torch.randn(shape, device="cuda", generator=g) * 1.5 + 0.3).to(dtype)
    c = shape[1]
    w = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=g)
    b = 0.1 * torch.randn(c, device="cuda", generator=g)
    kernels.reset_launches()
    y, stats = gn.gn1_gelu_fwd_stats(x, w, b, gelu)
    again = gn.gn1_gelu_fwd(x, w, b, gelu)
    torch.cuda.synchronize()
    assert dict(kernels.launches) == {"gn1_gelu_fwd_stream": 2}
    assert y.dtype == dtype
    assert torch.equal(y, again)
    assert _rel(y, gn.gn_gelu_plain(x, w, b, gelu)) < tol
    xf = x.float().reshape(shape[0], -1)
    mean = xf.mean(1)
    inv = torch.rsqrt(xf.var(1, unbiased=False) + gn.EPS)
    assert _rel(stats[:, 0], mean) < 1e-5
    assert _rel(stats[:, 1], inv) < 1e-4


def test_gn1_gelu_stream_constant_sample_clamps_variance():
    """The streaming variant's clamp: a constant sample of 777.7, whose f32
    E[x^2] - E[x]^2 may round below 0, gives a finite inv no larger than
    1/sqrt(eps), and y is the normalisation by the kernel's own (mean, inv)
    (their f32 rounding over 13.9 M elements, times 1/sqrt(eps), is what
    separates y from GELU(beta))."""
    from nps_tpu_torch import kernels
    from nps_tpu_torch.ops import group_norm as gn

    x = torch.full((1, 2048, 100, 68), 777.7, device="cuda")
    w = torch.ones(2048, device="cuda")
    b = torch.linspace(-1.0, 1.0, 2048, device="cuda")
    kernels.reset_launches()
    y, stats = gn.gn1_gelu_fwd_stats(x, w, b)
    assert dict(kernels.launches) == {"gn1_gelu_fwd_stream": 1}
    mean, inv = (float(v) for v in stats[0])
    assert torch.isfinite(y).all() and np.isfinite(inv)
    assert abs(mean - 777.7) < 1e-3 and 0 < inv <= (1 + 1e-6) / gn.EPS ** 0.5
    ref = torch.nn.functional.gelu((x - stats[0, 0]) * stats[0, 1]
                                   * w.reshape(1, -1, 1, 1)
                                   + b.reshape(1, -1, 1, 1))
    assert float((y - ref).abs().max()) < 1e-5


def test_bf16_engine_on_card_matches_cpu():
    """The ns512 config at a narrow width on a 32 x 32 grid in bf16 (every
    spectral call takes the large-plane variant in bf16): one step on the
    card against the port in bf16 on the CPU, and against the card in f32
    (a sanity bound on bf16, not a parity bar)."""
    from nps_tpu_torch import kernels
    from nps_tpu_torch.inference import SurrogateEngine
    from nps_tpu_torch.pde import PDE2D

    cfg = "nps_tpu_torch/configs/train/cfg_ns512_ufno.py"
    pde = PDE2D(tmin=0, tmax=1, nt=21, L1=1.0, L2=1.0, nx1=32, nx2=32,
                x=None, name="ns512", n_cond_static=0, n_cond_spatial=0)
    over = ["--model.hidden_features=16", "--model.hidden_blocks=2",
            "--model.fno_modes=4", "--time_window=5"]
    engines = {(dev, dt): SurrogateEngine.from_config(
        cfg, pde=pde, overrides=over, device=dev, compute_dtype=dt)
        for dev in ("cuda", "cpu") for dt in ("bfloat16", "float32")}
    for eng in engines.values():
        eng.init_params(seed=0)
    u0 = np.random.default_rng(0).random((2, 1, 5, 32, 32)).astype(
        np.float32)
    kernels.reset_launches()
    out = engines["cuda", "bfloat16"].step(u0)
    assert kernels.launches["spectral_dft2d_fwd_large"] == 2
    ref = engines["cpu", "bfloat16"].step(u0)
    f32 = engines["cuda", "float32"].step(u0)
    scale = np.abs(f32).max()
    assert np.abs(out - ref).max() / scale < 2e-2
    assert np.abs(out - f32).max() / scale < 5e-2


# ---- the backward at the ns512 shapes ---------------------------------------
# (b, ci, co, grid, modes): the ns512 plane (two row tiles), a partial row
# tile, scalar rows, a twophase plane (large in bf16 only)
BWD_LARGE_CASES = [
    (2, 6, 5, (512, 512), (20, 20)),
    (3, 5, 7, (300, 200), (20, 17)),
    (2, 4, 6, (130, 98), (20, 20)),
    (10, 9, 66, (96, 64), (10, 10)),
]


@pytest.mark.parametrize("b,ci,co,grid,modes", BWD_LARGE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("film_mode", [None, 0, 1])
def test_spectral_fn_large_backward_matches_plain_autograd(b, ci, co, grid,
                                                           modes, dtype,
                                                           film_mode):
    """SpectralConv2dFn where its backward takes the large-plane variant:
    y and dx (in x's type) against autograd through the plain version at
    1e-2 in bf16, 1e-4 in f32; the weight and FiLM gradients (f32) at
    1e-4."""
    from nps_tpu_torch import kernels
    from nps_tpu_torch.ops import spectral as sp

    bf16 = dtype == torch.bfloat16
    if not bf16 and sp._check_kernel_fits(
            b, co, *grid, *modes, "spectral_dft2d_bwd", c_out=ci) != "large":
        pytest.skip("f32 takes the resident backward at this shape")
    g = torch.Generator(device="cuda").manual_seed(10)
    x = torch.randn((b, ci) + grid, device="cuda", generator=g).to(dtype)
    ws = [torch.rand((2, ci, co) + modes, device="cuda", generator=g)
          / (ci * co) for _ in range(2)]
    dy = torch.randn((b, co) + grid, device="cuda", generator=g).to(dtype)
    leaves = [x, *ws]
    fm = 1
    if film_mode is not None:
        fm = film_mode
        leaves.append(torch.randn((b, co, 2 * modes[0], modes[1]),
                                  device="cuda", generator=g))
    kernels.reset_launches()
    got = _grads(lambda x, w1, w2, *f: sp.SpectralConv2dFn.apply(
        x, w1, w2, modes, f[0] if f else None, fm), leaves, dy)
    assert dict(kernels.launches) == {"spectral_dft2d_fwd_large": 1,
                                      "spectral_dft2d_bwd_large": 1,
                                      "spectral_dw2d": 1}
    ref = _grads(lambda x, w1, w2, *f: sp.spectral_conv_2d_plain(
        x, [w1, w2], modes, f[0] if f else None, fm), leaves, dy)
    tol = 1e-2 if bf16 else 1e-4
    names = ("y", "dx", "dw1", "dw2", "dfilm")
    for a, r, name in zip(got, ref, names):
        assert a.dtype == r.dtype, name
        assert _rel(a, r) < (tol if name in ("y", "dx") else 1e-4), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spectral_bwd_large_same_bits_at_ns512_shape(dtype):
    """The ns512 input gradient (dy [8, 128, 512, 512] -> dx [8, 132, 512,
    512], 20 x 20 modes): its launch against the plain version (dx at
    1e-2 in bf16, 1e-5 in f32; G at 1e-5), and two calls give the same
    bits."""
    from nps_tpu_torch import kernels
    from nps_tpu_torch.ops import spectral as sp

    g = torch.Generator(device="cuda").manual_seed(11)
    dy = torch.randn((8, 128, 512, 512), device="cuda", generator=g).to(dtype)
    ws = [torch.rand((2, 132, 128, 20, 20), device="cuda", generator=g)
          / (132 * 128) for _ in range(2)]
    wp = sp.pack_weights_2d(ws)
    kernels.reset_launches()
    got = sp.spectral_dft2d_bwd(dy, wp, (20, 20))
    again = sp.spectral_dft2d_bwd(dy, wp, (20, 20))
    torch.cuda.synchronize()
    assert dict(kernels.launches) == {"spectral_dft2d_bwd_large": 2}
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    ref = sp.spectral_dft2d_bwd_plain(dy, wp, (20, 20))
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert got[0].dtype == dtype and _rel(got[0], ref[0]) < tol
    assert _rel(got[1], ref[1]) < 1e-5 and _rel(got[2], ref[2]) < 1e-5


# the ns512 U-Net's largest norm input (vector path), its smallest (odd
# h*w: scalar path), a small odd shape
GN_BWD_BF16_SHAPES = [(2, 260, 526, 526), (8, 128, 125, 125), (3, 5, 7, 9)]


@pytest.mark.parametrize("shape", GN_BWD_BF16_SHAPES)
@pytest.mark.parametrize("gelu", [True, False])
def test_gn_gelu_fn_bf16_gradient_matches_plain_autograd(shape, gelu):
    """GNGeluFn in bf16: y and dx (bf16) against autograd through the plain
    version at 1e-2, dgamma and dbeta (f32) at 1e-4; the backward kernel
    gives the same bits on a second call."""
    from nps_tpu_torch import kernels
    from nps_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device="cuda").manual_seed(12)
    c = shape[1]
    x = (torch.randn(shape, device="cuda", generator=g) * 1.5
         + 0.3).to(torch.bfloat16)
    w = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=g)
    b = 0.1 * torch.randn(c, device="cuda", generator=g)
    dy = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
    kernels.reset_launches()
    got = _grads(lambda *t: gn.GNGeluFn.apply(*t, gelu, gn.EPS), (x, w, b), dy)
    assert kernels.launches["gn1_gelu_bwd"] == 1
    ref = _grads(lambda *t: gn.gn_gelu_plain(*t, gelu), (x, w, b), dy)
    for a, r, name in zip(got, ref, ("y", "dx", "dgamma", "dbeta")):
        assert a.dtype == r.dtype, name
        assert _rel(a, r) < (1e-2 if name in ("y", "dx") else 1e-4), name
    _, stats = gn.gn1_gelu_fwd_stats(x, w, b, gelu)
    first = gn.gn1_gelu_bwd(x, w, b, stats, dy, gelu)
    second = gn.gn1_gelu_bwd(x, w, b, stats, dy, gelu)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(first, second))


def _narrow_ns512(pde, remat):
    """The ns512 config's model at 2 blocks x 16 features, on the card."""
    from nps_tpu_torch.models.activation_wrapper import activation_wrapper
    from nps_tpu_torch.models.activations import GELUTanh, Tanh

    return activation_wrapper(
        model_class="EncProcDec", activation_final=Tanh(), num_c=1,
        num_spatial_dims=2, time_window=5, encoder="enc_grid.ElementWise",
        activation=GELUTanh(), processor="UFNO", fno_modes=20,
        hidden_blocks=2, hidden_features=16, padding_mode="circular",
        ch_mults=[1, 1, 1], is_attn=[False] * 3, norm=True, use1x1=True,
        remat=remat, remat_policy="save_conv_outputs",
        decoder="dec_grid.TimeConvDense", dec_delta_mode="per_step",
        pde=pde).cuda()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_train_step_matches_no_remat(dtype):
    """The ns512 config narrowed (2 blocks x 16 features, 20 modes, 64 x 64
    grid) on the card: a train step with its per-block remat
    (save_conv_outputs) against the same step without remat, loss at 1e-5
    and every gradient at 1e-4 of its largest. cuDNN runs its
    deterministic algorithms here: left to choose, its backward algorithms
    may sum in another order on each call, which bf16 rounding turns into
    differences far above these bars with or without remat. The
    rematerialized forward kernels launch twice per graded apply."""
    from nps_tpu_torch import kernels
    from nps_tpu_torch.models import config
    from nps_tpu_torch.pde import PDE2D

    pde = PDE2D(tmin=0, tmax=1, nt=21, L1=1.0, L2=1.0, nx1=64, nx2=64,
                x=None, name="ns512", n_cond_static=2, n_cond_spatial=2)
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.random((2, 1, 5, 64, 64), np.float32)).cuda()
    cond = torch.from_numpy(rng.random((2, 2), np.float32)).cuda()
    sc = torch.from_numpy((rng.random((2, 2, 64, 64)) > 0.8)
                          .astype(np.float32)).cuda()
    pos = torch.from_numpy(np.broadcast_to(
        pde.x[None], (2, 64, 64, 2)).astype(np.float32)).cuda()
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    out, state = {}, None
    try:
        cudnn.deterministic, cudnn.benchmark = True, False
        for remat in (True, False):
            model = _narrow_ns512(pde, remat)
            if state is None:
                state = model.state_dict()
            model.load_state_dict(state)
            kernels.reset_launches()
            with config.compute_dtype_scope(dtype):
                loss = model(u, cond=cond, pos=pos,
                             spatial_cond=sc).square().sum()
                loss.backward()
            torch.cuda.synchronize()
            out[remat] = (float(loss.detach()),
                          {k: p.grad.clone()
                           for k, p in model.named_parameters()},
                          dict(kernels.launches))
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    (loss_r, grads_r, n_r), (loss_n, grads_n, n_n) = out[True], out[False]
    assert abs(loss_r - loss_n) <= 1e-5 * abs(loss_n), (loss_r, loss_n)
    for k, gr in grads_r.items():
        ref = grads_n[k]
        err = float((gr - ref).abs().max()) / max(float(ref.abs().max()),
                                                  1e-30)
        assert err <= 1e-4, (k, err)
    for name in ("spectral_dft2d_fwd_large", "gn1_gelu_fwd"):
        assert n_r[name] == 2 * n_n[name] > 0, (name, n_r, n_n)
    for name in ("spectral_dft2d_bwd_large", "spectral_dw2d", "gn1_gelu_bwd"):
        assert n_r[name] == n_n[name] > 0, (name, n_r, n_n)


# ---- gn1_gelu_bwd with each activation, and the tanh GELU -----------------
# (shape, the backward's route and, on gn1_bwd_ticket, its per-plane path):
# a sample of x and dy under BWD_THREE_BELOW bytes takes the three-kernel
# route ("three"), a larger one the ticket kernel, where planes of up to
# 2048 elements take a warp each ("ticket-warp") and larger ones the whole
# CTA ("ticket-cta"); every plane takes 16-byte loads there where x and dy
# are 16-byte aligned, its elements outside whole units one by one (odd
# h * w). The twophase train shape, the time-conditioned one and at batch
# 1; many samples of few small planes, so that the ticket kernel's apply
# items wait on their samples' flags; the ns512 shapes at batch 1 and 2,
# batch 5.
GN_BWD_CLASSES = [
    ((5, 7, 13, 11), "three"),
    ((16, 64, 9, 5), "three"),
    ((16, 388, 100, 68), "ticket-cta"),
    ((16, 396, 100, 68), "ticket-cta"),
    ((1, 388, 100, 68), "ticket-cta"),
    ((64, 8, 16, 16), "three"),
    ((48, 72, 15, 15), "three"),
    ((1, 128, 125, 125), "ticket-cta"),
    ((2, 132, 263, 263), "ticket-cta"),
    ((2, 260, 526, 526), "ticket-cta"),
]
GN_ACTS = [(False, "none"), (True, "none"), (True, "tanh")]


def _gn_case(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, device="cuda", generator=g) * 1.5 + 0.3).to(dtype)
    w = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=g)
    b = 0.1 * torch.randn(c, device="cuda", generator=g)
    dy = torch.randn(shape, device="cuda", generator=g).to(dtype)
    return x, w, b, dy


@pytest.mark.parametrize("shape,cls", GN_BWD_CLASSES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gelu,approximate", GN_ACTS)
def test_gn1_gelu_bwd_matches_plain_autograd(shape, cls, dtype, gelu,
                                             approximate):
    """The backward kernel against autograd through the plain version: dx
    at 1e-4 in f32 and 1e-2 in bf16, dgamma and dbeta (f32) at 1e-4; the
    same bits on a second call."""
    from nps_tpu_torch import kernels
    from nps_tpu_torch.ops import group_norm as gn

    x, w, b, dy = _gn_case(shape, dtype, 13)
    route, _, path = cls.partition("-")
    assert gn.gn_bwd_route(x) == route
    vec, plan = gn.gn1_bwd_plan_for(x, dy)
    assert vec and (route == "three" or bool(plan.warp) == (path == "warp"))
    kernels.reset_launches()
    got = _grads(lambda *t: gn.GNGeluFn.apply(*t, gelu, gn.EPS, approximate),
                 (x, w, b), dy)
    assert dict(kernels.launches) == {
        ("gn1_gelu_fwd" if gn._plan(shape[0], x[0].numel(),
                                    dtype == torch.bfloat16)
         else "gn1_gelu_fwd_stream"): 1, "gn1_gelu_bwd": 1}
    assert dict(kernels.route_launches) == {("gn1_gelu_bwd", route): 1}
    ref = _grads(lambda *t: gn.gn_gelu_plain(*t, gelu, gn.EPS, approximate),
                 (x, w, b), dy)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for a, r, name in zip(got, ref, ("y", "dx", "dgamma", "dbeta")):
        assert a.dtype == r.dtype, name
        bar = tol if name in ("y", "dx") else 1e-4
        if name == "y" and dtype == torch.float32:
            bar = 1e-5
        assert _rel(a, r) < bar, (name, _rel(a, r))
    _, stats = gn.gn1_gelu_fwd_stats(x, w, b, gelu, gn.EPS, approximate)
    first = gn.gn1_gelu_bwd(x, w, b, stats, dy, gelu, approximate)
    second = gn.gn1_gelu_bwd(x, w, b, stats, dy, gelu, approximate)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(first, second))


def _held_at_the_bars(got, ref, dtype):
    """dx at 1e-4 in f32 and 1e-2 in bf16, dgamma and dbeta at 1e-4."""
    bars = (1e-2 if dtype == torch.bfloat16 else 1e-4, 1e-4, 1e-4)
    for a, r, bar, name in zip(got, ref, bars, ("dx", "dgamma", "dbeta")):
        assert a.dtype == r.dtype and _rel(a, r) < bar, (name, _rel(a, r))


@pytest.mark.parametrize("shape,cls", GN_BWD_CLASSES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn1_bwd_kernel_runs_every_item_once(shape, cls, dtype):
    """gn1_bwd_ticket at every shape, whichever route the wrapper takes
    there: the counters a call leaves (gn_bwd_plan's workspace): every
    ticket taken, every sums item done once, every sample's coef published,
    under the plan and with the L2 hints flipped; the same bits both ways,
    against autograd through the plain version."""
    from nps_tpu_torch.ops import group_norm as gn

    x, w, b, dy = _gn_case(shape, dtype, 16)
    _, stats = gn.gn1_gelu_fwd_stats(x, w, b)
    vec, plan = gn.gn1_bwd_plan_for(x, dy)
    n, outs = shape[0], []
    for p in (plan, plan._replace(hint=1 - plan.hint)):
        ctr = torch.empty(p.counters, dtype=torch.int32, device="cuda")
        outs.append(gn.launch_gn1_bwd(x, w, b, stats, dy, 1, vec, p, ctr))
        torch.cuda.synchronize()
        c = ctr.tolist()
        assert c[:2] == [p.grid, n]
        assert c[2:2 + n] == [p.items] * n and c[2 + n:] == [2] * n
    assert all(torch.equal(u, v) for u, v in zip(*outs))
    ref = _grads(lambda *t: gn.gn_gelu_plain(*t, True, gn.EPS, "none"),
                 (x, w, b), dy)[1:]
    _held_at_the_bars(outs[0], ref, dtype)


@pytest.mark.parametrize("shape,cls", GN_BWD_CLASSES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("approximate", ["none", "tanh"])
def test_gn1_bwd_three_kernel_route_matches_plain_autograd(shape, cls, dtype,
                                                           approximate):
    """The three-kernel route at every shape, whichever route the wrapper
    takes there: against autograd through the plain version, the same bits
    twice."""
    from nps_tpu_torch.ops import group_norm as gn

    x, w, b, dy = _gn_case(shape, dtype, 17)
    _, stats = gn.gn1_gelu_fwd_stats(x, w, b, True, gn.EPS, approximate)
    act = gn._act(True, approximate)
    got = gn.launch_gn1_bwd_three(x, w, b, stats, dy, act)
    again = gn.launch_gn1_bwd_three(x, w, b, stats, dy, act)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    ref = _grads(lambda *t: gn.gn_gelu_plain(*t, True, gn.EPS, approximate),
                 (x, w, b), dy)[1:]
    _held_at_the_bars(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("approximate", ["none", "tanh"])
def test_gn1_gelu_bwd_misaligned_view(dtype, approximate):
    """x and dy as views one element into their storage: planes of a
    multiple of 4 elements that take the scalar path, as they are not
    aligned, through the wrapper's route and through gn1_bwd_ticket,
    against autograd through the plain version."""
    from nps_tpu_torch.ops import group_norm as gn

    shape = (3, 20, 16, 9)
    n = int(np.prod(shape))
    g = torch.Generator(device="cuda").manual_seed(15)
    x0 = (torch.randn(n + 1, device="cuda", generator=g) * 1.5
          + 0.3).to(dtype)
    dy0 = torch.randn(n + 1, device="cuda", generator=g).to(dtype)
    w = 1.0 + 0.2 * torch.randn(shape[1], device="cuda", generator=g)
    b = 0.1 * torch.randn(shape[1], device="cuda", generator=g)
    x, dy = x0[1:].view(shape), dy0[1:].view(shape)
    assert x.data_ptr() % 16 and dy.data_ptr() % 16
    assert gn.gn1_bwd_plan_for(x, dy)[0] == 0
    _, stats = gn.gn1_gelu_fwd_stats(x, w, b, True, gn.EPS, approximate)
    ref = _grads(lambda *t: gn.gn_gelu_plain(*t, True, gn.EPS, approximate),
                 (x, w, b), dy)[1:]
    vec, plan = gn.gn1_bwd_plan_for(x, dy)
    act = gn._act(True, approximate)
    for call in (lambda: gn.gn1_gelu_bwd(x, w, b, stats, dy, True,
                                         approximate),
                 lambda: gn.launch_gn1_bwd(x, w, b, stats, dy, act, vec,
                                           plan)):
        got, again = call(), call()
        torch.cuda.synchronize()
        tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
        assert _rel(got[0], ref[0]) < tol
        assert _rel(got[1], ref[1]) < 1e-4 and _rel(got[2], ref[2]) < 1e-4
        assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("shape", [(3, 5, 7, 9), (4, 388, 100, 68),
                                   (2, 24, 17, 13), (1, 260, 526, 526),
                                   (2, 132, 263, 263)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_gn1_gelu_forward_tanh_matches_plain(shape, dtype, tol):
    """Both forward variants (the persistent one; the streaming one for the
    526^2 shape, and for the 263^2 one in f32) with the tanh GELU against
    the plain version (F.gelu approximate="tanh" on the f32 normalisation),
    the same bits twice."""
    from nps_tpu_torch import kernels
    from nps_tpu_torch.ops import group_norm as gn

    x, w, b, _ = _gn_case(shape, dtype, 16)
    variant = ("gn1_gelu_fwd" if gn._plan(shape[0], x[0].numel(),
                                          dtype == torch.bfloat16)
               else "gn1_gelu_fwd_stream")
    assert (variant == "gn1_gelu_fwd_stream") == (
        shape[-1] == 526 or (shape[-1] == 263 and dtype == torch.float32))
    kernels.reset_launches()
    y = gn.gn1_gelu_fwd(x, w, b, True, gn.EPS, "tanh")
    again = gn.gn1_gelu_fwd(x, w, b, True, gn.EPS, "tanh")
    torch.cuda.synchronize()
    assert dict(kernels.launches) == {variant: 2}
    assert torch.equal(y, again)
    assert _rel(y, gn.gn_gelu_plain(x, w, b, True, gn.EPS, "tanh")) < tol
    op = torch.ops.nps_torch.gn1_gelu_fwd(x, w, b, True, gn.EPS, "tanh")
    assert torch.equal(op, y)


@pytest.mark.parametrize("film_mode", [None, 0, 1])
def test_spectral_conv_1d_on_card_matches_cpu(film_mode):
    """The 1D spectral conv (torch.einsum in f32, no hand kernel, TF32 off)
    on the card against the CPU: output and the gradients of x, the
    weights and the FiLM scales, at cfg_var1d_fno's 64 features, 32 points
    and 8 modes; it launches no kernel of the port."""
    from nps_tpu_torch import kernels
    from nps_tpu_torch.ops.spectral import spectral_conv_nd

    g = torch.Generator().manual_seed(21)
    x = torch.randn((8, 66, 32), generator=g)
    w = torch.rand((2, 66, 64, 8), generator=g) / (66 * 64)
    film = (torch.randn((8, 64, 8), generator=g) if film_mode is not None
            else None)
    dy = torch.randn((8, 64, 32), generator=g)
    res = {}
    kernels.reset_launches()
    for dev in ("cpu", "cuda"):
        leaves = [t.to(dev).detach().requires_grad_() for t in (
            (x, w) if film is None else (x, w, film))]
        out = spectral_conv_nd(leaves[0], [leaves[1]], (8,),
                               film=leaves[2] if film is not None else None,
                               film_mode=film_mode or 0, num_spatial_dims=1)
        (out * dy.to(dev)).sum().backward()
        res[dev] = [out.detach().cpu()] + [t.grad.cpu() for t in leaves]
    torch.cuda.synchronize()
    assert not any(kernels.launches.values())
    for a, ref in zip(res["cuda"], res["cpu"]):
        assert _rel(a, ref) < 1e-5


def test_grad_accum_on_card_steps_at_the_boundary_with_fresh_packs():
    """A spectral layer trained on the card under MultiSteps(Adam, 2): the
    weights hold after the first mini-step and move at the second, as on
    the CPU (1e-4), and a serving block's weight pack is built from the
    weights after the boundary step."""
    from nps_tpu_torch.models.fno import (SpectralConvND,
                                          packed_spectral_weights)
    from nps_tpu_torch.ops import spectral as sp
    from nps_tpu_torch.train.optim import MultiSteps

    torch.manual_seed(3)
    cpu = SpectralConvND(24, 16, (6, 6), 2)
    card = SpectralConvND(24, 16, (6, 6), 2).cuda()
    card.load_state_dict(cpu.state_dict())
    xs = [torch.randn((2, 24, 32, 24)) for _ in range(2)]
    weights = {}
    for dev, layer in (("cpu", cpu), ("cuda", card)):
        opt = MultiSteps(torch.optim.Adam(layer.parameters(), lr=1e-2), 2)
        w0 = layer.weights1.detach().clone()
        for i, x in enumerate(xs):
            opt.zero_grad()
            layer(x.to(dev)).square().mean().backward()
            opt.step()
            moved = not torch.equal(layer.weights1.detach(), w0)
            assert moved == (i == 1), (dev, i)
        weights[dev] = [w.detach().cpu() for w in (layer.weights1,
                                                  layer.weights2)]
    for a, ref in zip(weights["cuda"], weights["cpu"]):
        assert _rel(a, ref) < 1e-4
    x = xs[0].cuda()
    with torch.inference_mode(), packed_spectral_weights(card):
        out = card(x)
        ref = sp.spectral_conv_2d_plain(x, [card.weights1, card.weights2],
                                        (6, 6))
    assert _rel(out, ref) < 1e-5


def test_var1d_engine_on_card_captured_matches_eager_and_cpu():
    """cfg_var1d_fno at full width (2 x 64, 8 modes) served by the engine on
    the card: a 6-step rollout against the CPU engine (1e-4) and captured
    against eager (1e-6)."""
    from nps_tpu_torch.inference import SurrogateEngine
    from nps_tpu_torch.pde import PDE1D

    pde = PDE1D(0.0, 10.0, 100, 1.0, 32, None, "var1d", n_cond_static=2)
    cfg = "nps_tpu_torch/configs/train/cfg_var1d_fno.py"
    engines = {d: SurrogateEngine.from_config(cfg, pde=pde, device=d)
               for d in ("cpu", "cuda")}
    for eng in engines.values():
        eng.init_params(seed=4)
    rng = np.random.default_rng(4)
    u0 = rng.random((8, 2, 5, 32)).astype(np.float32)
    cond = rng.random((8, 2)).astype(np.float32)
    eager = engines["cuda"].rollout(u0, 6, cond=cond)
    ref = engines["cpu"].rollout(u0, 6, cond=cond)
    captured = engines["cuda"].rollout(u0, 6, cond=cond, captured=True)
    assert eager.shape == (8, 2, 30, 32)
    assert _rel(torch.from_numpy(eager), torch.from_numpy(ref)) < 1e-4
    assert _rel(torch.from_numpy(captured), torch.from_numpy(eager)) < 1e-6


# ---- the mixture of experts, pushforward_fast, the MP-GNN in bf16 ----------

def _two_applies_loss_and_grads(eng, u0, cond, sc, dtype=None):
    """Two model applies with gradients (the first detached, as a depth-1
    pushforward step), the squared mean of the second: (loss, gradients by
    parameter on the host)."""
    from nps_tpu_torch.models.config import compute_dtype_scope

    u, c, s = (None if a is None else torch.from_numpy(a).to(eng.device)
               for a in (u0, cond, sc))
    eng.model.zero_grad()
    with compute_dtype_scope(dtype):
        h = eng._apply(u, c, eng._pos(u.shape[0]), s).detach()
        loss = eng._apply(h, c, eng._pos(u.shape[0]), s).float() \
            .square().mean()
        loss.backward()
    return float(loss.detach()), {k: p.grad.float().cpu()
                         for k, p in eng.model.named_parameters()}


def test_moe_train_step_on_card_matches_cpu():
    """The small MoE (2 blocks x 4 experts): a depth-1 step's loss and
    every gradient, each expert's and each gate's, against the CPU (1e-4,
    5e-3), through K1 only: per apply one forward launch an expert, per
    backward one input-gradient and one weight-gradient launch an
    expert."""
    from nps_tpu_torch import kernels

    gpu, cpu = _small_engine("moe"), _small_engine("moe", "cpu")
    cpu.model.load_state_dict({k: v.cpu()
                               for k, v in gpu.model.state_dict().items()})
    u0, cond, sc = _small_inputs()
    kernels.reset_launches()
    loss, grads = _two_applies_loss_and_grads(gpu, u0, cond, sc)
    torch.cuda.synchronize()
    assert dict(kernels.launches) == {"spectral_dft2d_fwd": 16,
                                      "spectral_dft2d_bwd": 8,
                                      "spectral_dw2d": 8}
    loss_cpu, grads_cpu = _two_applies_loss_and_grads(cpu, u0, cond, sc)
    assert abs(loss - loss_cpu) / abs(loss_cpu) < 1e-4
    assert any(".gate." in k for k in grads)
    floor = 1e-5 * max(float(g.abs().max()) for g in grads_cpu.values())
    for k, g in grads_cpu.items():
        scale = max(float(g.abs().max()), floor)
        assert float((grads[k] - g).abs().max()) / scale < 5e-3, k


def _ufno_trainer(tmp_path, device, *extra):
    import sys

    from nps_tpu_torch import train_cli
    from nps_tpu_torch.configs.parse import parse_args

    saved = sys.argv
    try:
        sys.argv = ["prog", "--base_resolution=[21,24,16]",
                    "--super_resolution=[21,24,16]", "--time_window=5",
                    "--batch_size=2", f"--dataset.base_path={tmp_path}",
                    "--dataset.c_filter=[0]", "--model.hidden_features=8",
                    "--model.hidden_blocks=1", "--model.fno_modes=4",
                    f"--experiment_path={tmp_path}/out", *extra]
        args = parse_args("nps_tpu_torch/configs/train/cfg_twophase_ufno.py")
    finally:
        sys.argv = saved
    trainer = train_cli.get_config_static(args, device=device)[4]
    trainer.set_optimizer(dict(args["optimizer"]))
    trainer.ensure_initialized()   # builds its optimizer
    return trainer


def test_pushforward_fast_no_grad_applies_launch_k2_tanh(tmp_path):
    """A small U-FNO trained with --trainer.pushforward_fast=true on the
    card: at depth 2 the two no-grad applies launch K2 with the tanh GELU
    (act 2), the graded apply with the config's exact one (act 1); the loss
    against the same step on the CPU (1e-4)."""
    from nps_tpu_torch import kernels
    from nps_tpu_torch.data.synthetic import generate

    generate(str(tmp_path / "twophase"), n_sims=6, n_channels=1, nt=21,
             nx1=24, nx2=16, seed=2)
    fast = "--trainer.pushforward_fast=true"
    gpu = _ufno_trainer(tmp_path, "cuda", fast)
    cpu = _ufno_trainer(tmp_path, "cpu", fast)
    cpu.model.load_state_dict({k: v.cpu()
                               for k, v in gpu.model.state_dict().items()})
    batch = tuple(torch.as_tensor(np.asarray(t))
                  for t in next(iter(cpu.get_dataloaders()[0])))
    steps0 = torch.tensor([5, 6])
    kernels.reset_launches()
    loss = gpu.train_step(tuple(t.cuda() for t in batch), 0, 0, unrolled=2,
                          steps0=steps0)[0]
    torch.cuda.synchronize()
    acts = dict(kernels.act_launches)
    per_apply = acts.get(("gn1_gelu_fwd", 1), 0)
    assert per_apply > 0
    assert acts == {("gn1_gelu_fwd", 1): per_apply,
                    ("gn1_gelu_fwd", 2): 2 * per_apply}
    loss_cpu = cpu.train_step(batch, 0, 0, unrolled=2, steps0=steps0)[0]
    assert abs(float(loss) - float(loss_cpu)) / abs(float(loss_cpu)) < 1e-4


def test_gnn_bf16_engine_and_train_step_on_card_match_cpu():
    """The small MP-GNN in bf16 on the card against the CPU in bf16 at the
    bf16 bar, the CPU in f32 as the reference: |card - CPU_bf16| /
    max|CPU_f32| <= max(2 d, 8e-3), d the CPU's own bf16-vs-f32 deviation,
    for one serving step (max terms) and a depth-1 step's loss and
    gradients (all parameters' RMS terms)."""
    from nps_tpu_torch.models.config import resolve_compute_dtype

    gpu, cpu = _small_engine("gnn"), _small_engine("gnn", "cpu")
    cpu.model.load_state_dict({k: v.cpu()
                               for k, v in gpu.model.state_dict().items()})
    u0, cond, _ = _small_inputs()
    bf16 = "bfloat16"

    def bar(got, ref16, ref32, norm):
        scale = norm(ref32)
        d, err = norm(ref16 - ref32) / scale, norm(got - ref16) / scale
        assert err <= max(2 * d, 8e-3), (err, d)

    def at(eng, dtype):
        eng.compute_dtype = resolve_compute_dtype(dtype)
        return eng.step(u0, cond=cond)

    out, ref16, ref32 = at(gpu, bf16), at(cpu, bf16), at(cpu, None)
    bar(out, ref16, ref32, lambda a: float(np.abs(a).max()))
    loss, grads = _two_applies_loss_and_grads(gpu, u0, cond, None, bf16)
    loss16, grads16 = _two_applies_loss_and_grads(cpu, u0, cond, None, bf16)
    loss32, grads32 = _two_applies_loss_and_grads(cpu, u0, cond, None)
    bar(np.float64(loss), np.float64(loss16), np.float64(loss32), abs)

    def flat(g):
        return torch.cat([g[k].flatten() for k in sorted(g)]).numpy()

    bar(flat(grads), flat(grads16), flat(grads32),
        lambda a: float(np.sqrt(np.mean(np.square(a)))))
