"""The port's spectral conv (plain path, the CPU half of kernel K1) against
``nps_tpu.ops.spectral.spectral_conv_nd``.

Same numpy inputs through both; JAX at precision="highest". Bar: forward
max|d| / max|ref| < 1e-4 (ROADMAP "How a part is held"); f32 sums in
another order differ at ~1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from nps_tpu.ops.spectral import spectral_conv_nd as jax_spectral
from nps_tpu_torch.ops import spectral as port

REL = 1e-4


def _rel(a, ref):
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _inputs(rng, b, n1, n2, ci, co, modes, film):
    x = rng.standard_normal((b, n1, n2, ci)).astype(np.float32)  # [b,*sp,c]
    ws = [(rng.random((2, ci, co) + tuple(modes)) / (ci * co)).astype(
        np.float32) for _ in range(2)]
    f = (rng.standard_normal((b, co, 2 * modes[0], modes[1])).astype(
        np.float32) if film else None)
    return x, ws, f


def _both(x, ws, modes, film=None, film_mode=1):
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax_spectral(x, ws, modes, film=film,
                                      film_mode=film_mode,
                                      precision="highest"))
    out = port.spectral_conv_nd(
        torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
        [torch.from_numpy(w) for w in ws], modes,
        film=None if film is None else torch.from_numpy(film),
        film_mode=film_mode)
    return out.permute(0, 2, 3, 1).numpy(), ref


@pytest.mark.parametrize("grid,modes", [
    ((16, 12), (4, 4)),
    ((12, 10), (4, 4)),
    ((16, 12), (3, 12 // 2 + 1)),   # Nyquist column kept
    ((12, 10), (3, 10 // 2 + 1)),
])
def test_spectral_matches_jax(grid, modes):
    rng = np.random.default_rng(1)
    x, ws, _ = _inputs(rng, 2, *grid, ci=5, co=7, modes=modes, film=False)
    out, ref = _both(x, ws, modes)
    assert out.shape == ref.shape == (2, *grid, 7)
    assert _rel(out, ref) < REL


@pytest.mark.parametrize("film_mode", [0, 1])
def test_spectral_film_matches_jax(film_mode):
    rng = np.random.default_rng(2)
    modes = (4, 4)
    x, ws, f = _inputs(rng, 2, 16, 12, ci=6, co=4, modes=modes, film=True)
    out, ref = _both(x, ws, modes, film=f, film_mode=film_mode)
    assert _rel(out, ref) < REL


@pytest.mark.parametrize("grid,modes", [
    ((16, 12), (4, 8)),    # modes[-1] beyond the half spectrum (7)
    ((12, 10), (7, 4)),    # 2*modes[0] beyond the rows
])
def test_spectral_mode_range_errors(grid, modes):
    rng = np.random.default_rng(3)
    x, ws, _ = _inputs(rng, 1, *grid, ci=2, co=2, modes=modes, film=False)
    with pytest.raises(ValueError):
        jax_spectral(x, ws, modes)
    with pytest.raises(ValueError):
        _both(x, ws, modes)


@pytest.mark.parametrize("shape,modes", [((2, 3, 16), (4,)),
                                         ((2, 3, 8, 8, 8), (2, 2, 2))])
def test_spectral_1d_3d_not_ported(shape, modes):
    x = torch.zeros(shape)
    with pytest.raises(NotImplementedError):
        port.spectral_conv_nd(x, [], modes)


@pytest.mark.parametrize("b,ci,co,grid,modes", [
    (2, 5, 3, (12, 10), (3, 4)),     # even n2 below the Nyquist column
    (3, 4, 6, (12, 10), (3, 6)),     # the Nyquist column kept (h = 1)
    (1, 3, 4, (10, 9), (5, 5)),      # odd n2, 2*m1 = n1
])
def test_spectral_fn_gradient_matches_jax_vjp(monkeypatch, b, ci, co, grid,
                                              modes):
    """SpectralConv2dFn's backward design (the adjoint launch on the
    forward's pack and the weight-gradient kernel, both through their plain
    versions in the launches' place) against ``jax.vjp`` of the reference,
    same numpy inputs and cotangent. Bar: the gradient bar of ROADMAP "How
    a part is held", 5e-3, as max|d| / max|ref|."""
    monkeypatch.setattr(port, "spectral_dft2d_fwd_spectrum",
                        port.spectral_dft2d_fwd_spectrum_plain)
    monkeypatch.setattr(port, "spectral_dft2d_bwd",
                        port.spectral_dft2d_bwd_plain)
    monkeypatch.setattr(port, "spectral_dw2d", port.spectral_weight_grad)
    rng = np.random.default_rng(5)
    x, ws, _ = _inputs(rng, b, *grid, ci=ci, co=co, modes=modes, film=False)
    dy = rng.standard_normal((b, *grid, co)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda x, w1, w2: jax_spectral(
            x, [w1, w2], modes, precision="highest"), x, *ws)
        refs = [np.asarray(t) for t in vjp(dy)]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    wt = [torch.from_numpy(w).requires_grad_() for w in ws]
    out = port.SpectralConv2dFn.apply(xt, wt[0], wt[1], modes)
    got = torch.autograd.grad(
        out, [xt, *wt], torch.from_numpy(dy).permute(0, 3, 1, 2).contiguous())
    got = [got[0].permute(0, 2, 3, 1).numpy(), got[1].numpy(),
           got[2].numpy()]
    for g, ref, name in zip(got, refs, ("dx", "dw1", "dw2")):
        assert g.shape == ref.shape, name
        assert _rel(g, ref) < 5e-3, name


def test_pack_weights_layout():
    """The kernel's packed weights hold mode (k, m) at row k*m2 + m, low row
    modes from weights1 then high ones from weights2."""
    rng = np.random.default_rng(4)
    ws = [torch.from_numpy(rng.random((2, 3, 5, 2, 4)).astype(np.float32))
          for _ in range(2)]
    packed = port.pack_weights_2d(ws)
    assert packed.shape == (2 * 2 * 4, 2, 3, 5) and packed.is_contiguous()
    for k in range(4):
        for m in range(4):
            src = ws[0][:, :, :, k, m] if k < 2 else ws[1][:, :, :, k - 2, m]
            assert torch.equal(packed[k * 4 + m], src)


def test_spectral_cuda_tensor_never_takes_plain_path(monkeypatch):
    """A CUDA tensor goes to the kernel wrapper, never to the plain op."""
    calls = []
    monkeypatch.setattr(port, "spectral_dft2d_fwd",
                        lambda *a, **k: calls.append("kernel"))
    monkeypatch.setattr(port, "spectral_conv_2d_plain",
                        lambda *a, **k: calls.append("plain"))

    class FakeCuda(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    x = torch.zeros(1, 2, 8, 8).as_subclass(FakeCuda)
    w = [torch.zeros(2, 2, 2, 2, 2)] * 2
    port.spectral_conv_nd(x, w, (2, 2), w_packed=torch.zeros(1))
    assert calls == ["kernel"]
