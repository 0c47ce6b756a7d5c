"""The gradients of the port's two kernel ops, checked on the CPU.

``GNGeluFn`` and ``SpectralConv2dFn`` launch CUDA kernels, which do not run
here. Their backward designs are held on the CPU by putting a plain
emulation of exactly what each kernel computes in the launch's place: for
K1 the forward kernel's output and its spectrum scratch, for K2 the
forward's statistics and the backward kernel's two-pass formula. The
Function's gradient must then equal autograd through the plain version.
The kernels themselves are held against the same plain autograd on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Bar: max|d| / max|ref| < 1e-5 in f32 (the same sums in another order).
Also held here: the weights packed once for a block of calls
(``packed_spectral_weights``) are the weights after an optimizer step,
whichever Adam implementation makes it.
"""

import numpy as np
import pytest
import torch

from nps_tpu_torch.models import fno
from nps_tpu_torch.models.fno import SpectralConvND, packed_spectral_weights
from nps_tpu_torch.ops import group_norm as gn
from nps_tpu_torch.ops import spectral as sp

REL = 1e-5


def _rel(a, ref):
    return float((a - ref).detach().abs().max() / ref.detach().abs().max())


# ---- K1 ---------------------------------------------------------------------
def _fake_spectral_launch(x, w_packed, modes, film=None, film_mode=1,
                          op="spectral_dft2d_fwd"):
    """What ``spectral_dft2d_fwd_spectrum`` returns, in plain PyTorch: the
    output, and X = sum u e^{-i theta} at the retained modes as [modes, b, c]
    real and imaginary parts."""
    assert film is None
    m1, m2 = modes
    b, ci, n1, n2 = x.shape
    k = 2 * m1
    co = w_packed.shape[3]
    w = w_packed.reshape(k, m2, 2, ci, co).permute(2, 3, 4, 0, 1)
    out = sp.spectral_conv_2d_plain(x, [w[:, :, :, :m1], w[:, :, :, m1:]],
                                    modes)
    ang_y = 2 * np.pi * np.outer(np.arange(n2), np.arange(m2)) / n2
    rows = np.concatenate([np.arange(m1), np.arange(n1 - m1, n1)])
    ang_x = 2 * np.pi * np.outer(np.arange(n1), rows) / n1
    phase = torch.from_numpy(ang_x[:, None, :, None] + ang_y[None, :, None, :])
    xd = x.double()
    re = torch.einsum("bcxy,xykm->kmbc", xd, torch.cos(phase))
    im = -torch.einsum("bcxy,xykm->kmbc", xd, torch.sin(phase))
    return (out, re.reshape(k * m2, b, ci).float(),
            im.reshape(k * m2, b, ci).float())


@pytest.mark.parametrize("b,ci,co,grid,modes", [
    (2, 5, 3, (12, 10), (3, 4)),     # even n2 below the Nyquist column
    (3, 4, 6, (12, 10), (3, 6)),     # the Nyquist column kept (h = 1)
    (1, 3, 4, (10, 9), (5, 5)),      # odd n2, 2*m1 = n1
])
def test_spectral_fn_gradient_matches_plain_autograd(monkeypatch, b, ci, co,
                                                      grid, modes):
    monkeypatch.setattr(sp, "spectral_dft2d_fwd_spectrum",
                        _fake_spectral_launch)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((b, ci) + grid, generator=g, requires_grad=True)
    ws = [torch.rand((2, ci, co) + modes, generator=g).requires_grad_()
          for _ in range(2)]
    dy = torch.randn((b, co) + grid, generator=g)

    out = sp.SpectralConv2dFn.apply(x, ws[0], ws[1], modes)
    grads = torch.autograd.grad(out, [x, *ws], dy)
    ref_out = sp.spectral_conv_2d_plain(x, ws, modes)
    refs = torch.autograd.grad(ref_out, [x, *ws], dy)
    assert _rel(out, ref_out) < REL
    for got, ref, name in zip(grads, refs, ("dx", "dw1", "dw2")):
        assert got.shape == ref.shape, name
        assert _rel(got, ref) < REL, name


def test_adjoint_packing_is_the_conjugate_transpose():
    g = torch.Generator().manual_seed(1)
    ws = [torch.randn((2, 3, 5, 2, 4), generator=g) for _ in range(2)]
    fwd = sp.pack_weights_2d(ws)          # [M, 2, ci, co]
    adj = sp.pack_adjoint_weights_2d(ws)  # [M, 2, co, ci]
    torch.testing.assert_close(adj[:, 0], fwd[:, 0].transpose(1, 2))
    torch.testing.assert_close(adj[:, 1], -fwd[:, 1].transpose(1, 2))


# ---- K2 ---------------------------------------------------------------------
def _fake_gn_fwd_stats(x, weight, bias, gelu=True, eps=gn.EPS):
    xf = x.reshape(x.shape[0], -1)
    mean = xf.mean(1)
    inv = torch.rsqrt(torch.clamp((xf * xf).mean(1) - mean * mean, min=0.0)
                      + eps)
    return (gn.gn_gelu_plain(x, weight, bias, gelu, eps),
            torch.stack([mean, inv], 1))


def _fake_gn_bwd(x, weight, bias, stats, dy, gelu=True):
    """``gn1_gelu_bwd``'s three passes in plain PyTorch: per-plane sums of g
    and g * xh, then per-sample and per-channel sums of those, then dx."""
    b, c = x.shape[:2]
    xf, dyf = x.reshape(b, c, -1), dy.reshape(b, c, -1)
    mean, inv = stats[:, 0, None, None], stats[:, 1, None, None]
    xh = (xf - mean) * inv
    pre = xh * weight[None, :, None] + bias[None, :, None]
    if gelu:
        cdf = 0.5 * (1 + torch.erf(pre / np.sqrt(2)))
        pdf = torch.exp(-0.5 * pre * pre) / np.sqrt(2 * np.pi)
        g = dyf * (cdf + pre * pdf)
    else:
        g = dyf
    ws = torch.stack([g.sum(2), (g * xh).sum(2)], -1)           # [b, c, 2]
    n = xf[0].numel()
    coef = (weight[None, :, None] * ws).sum(1) / n                # [b, 2]
    dx = inv * (g * weight[None, :, None] - coef[:, 0, None, None]
                - xh * coef[:, 1, None, None])
    return dx.reshape(x.shape), ws[..., 1].sum(0), ws[..., 0].sum(0)


@pytest.mark.parametrize("shape", [(3, 5, 7, 9), (2, 8, 6, 4), (2, 4, 3, 5, 6)])
@pytest.mark.parametrize("gelu", [True, False])
def test_gn_gelu_fn_gradient_matches_plain_autograd(monkeypatch, shape, gelu):
    monkeypatch.setattr(gn, "gn1_gelu_fwd_stats", _fake_gn_fwd_stats)
    monkeypatch.setattr(gn, "gn1_gelu_bwd", _fake_gn_bwd)
    g = torch.Generator().manual_seed(2)
    c = shape[1]
    x = (torch.randn(shape, generator=g) * 1.5 + 0.3).requires_grad_()
    w = (1.0 + 0.2 * torch.randn(c, generator=g)).requires_grad_()
    bb = (0.1 * torch.randn(c, generator=g)).requires_grad_()
    dy = torch.randn(shape, generator=g)

    out = gn.GNGeluFn.apply(x, w, bb, gelu, gn.EPS)
    grads = torch.autograd.grad(out, [x, w, bb], dy)
    ref_out = gn.gn_gelu_plain(x, w, bb, gelu)
    refs = torch.autograd.grad(ref_out, [x, w, bb], dy)
    assert _rel(out, ref_out) < REL
    for got, ref, name in zip(grads, refs, ("dx", "dgamma", "dbeta")):
        assert _rel(got, ref) < 1e-4, name


def test_cpu_path_keeps_autograd_through_the_plain_versions():
    """A CPU tensor never reaches the Functions, and its gradient flows."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 4, 8, 6), generator=g, requires_grad=True)
    w = torch.ones(4, requires_grad=True)
    b = torch.zeros(4, requires_grad=True)
    gn.gn_gelu(x, w, b).sum().backward()
    assert x.grad is not None and w.grad.abs().sum() > 0
    ws = [torch.rand((2, 4, 3, 2, 3), generator=g).requires_grad_()
          for _ in range(2)]
    sp.spectral_conv_nd(x, ws, (2, 3)).square().sum().backward()
    assert all(w.grad.abs().sum() > 0 for w in ws)


def test_tables_built_under_inference_mode_serve_autograd_later():
    """Serving first (inference mode) and training after, in one process:
    the cached DFT tables must not be inference tensors."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn((1, 3, 14, 10), generator=g)
    ws = [torch.rand((2, 3, 2, 3, 4), generator=g) for _ in range(2)]
    with torch.inference_mode():
        sp.spectral_conv_nd(x, ws, (3, 4))
    x.requires_grad_()
    sp.spectral_conv_nd(x, ws, (3, 4)).sum().backward()
    assert x.grad is not None


# ---- the packed-weight cache ------------------------------------------------
@pytest.mark.parametrize("impl", ["for-loop", "foreach", "fused"])
def test_packed_weight_cache_sees_an_optimizer_step(impl):
    torch.manual_seed(0)
    layer = SpectralConvND(4, 3, (2, 3), 2)
    with packed_spectral_weights(layer):
        before = layer.w_packed
        torch.testing.assert_close(
            before, sp.pack_weights_2d([layer.weights1, layer.weights2]),
            rtol=0, atol=0)
    assert layer.w_packed is None  # dropped at the block's end
    kw = {"for-loop": dict(foreach=False), "foreach": dict(foreach=True),
          "fused": dict(fused=True)}[impl]
    opt = torch.optim.Adam(layer.parameters(), lr=0.1, **kw)
    x = torch.randn(2, 4, 8, 6)
    layer(x).square().sum().backward()
    opt.step()
    with packed_spectral_weights(layer):
        after = layer.w_packed
    assert not torch.equal(after, before)
    torch.testing.assert_close(
        after, sp.pack_weights_2d([layer.weights1, layer.weights2]),
        rtol=0, atol=0)


def test_packed_weights_reach_the_op_only_inside_the_block(monkeypatch):
    """The layer hands the block's pack to the op, and nothing outside a
    block: there each call packs its own."""
    seen = []

    def record(x, weights, modes, w_packed=None, **kw):
        seen.append(w_packed)
        return sp.spectral_conv_2d_plain(x, weights, modes)

    monkeypatch.setattr(fno, "spectral_conv_nd", record)
    torch.manual_seed(1)
    model = torch.nn.Sequential(SpectralConvND(4, 4, (2, 3), 2),
                                SpectralConvND(4, 3, (2, 3), 2))
    x = torch.randn(2, 4, 8, 6)
    model(x)
    with torch.inference_mode(), packed_spectral_weights(model):
        model(x)
        packs = [m.w_packed for m in model]
    assert seen[:2] == [None, None]
    assert all(a is b for a, b in zip(seen[2:], packs))
    assert all(m.w_packed is None for m in model)
