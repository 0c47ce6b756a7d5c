"""The 3D spectral conv on a row split (``ops.spectral.spectral_conv_3d_split``
and its stages) in one process: K "ranks" each take the partial spectrum of
their rows (``spectrum_3d_rows``), the partial spectra are summed by hand
(what ``parallel.spatial.spatial_sum`` does over the x group, forward and
backward), the mix runs on the sum (``mix_3d``) and each rank inverts to
its own rows (``inverse_3d_rows``). The rows put back in order are held
against ``spectral_conv_3d`` (itself held against JAX by
``test_torch_3d.py``), output and gradients, at K = 2 and at K = 3 over an
uneven 10 rows (3 / 3 / 4, ``parallel.spatial.part``).

Bars: the forward max|d| / max|ref| <= 1e-5, each gradient (of x and of
the four weights) <= 5e-5 of its own max |ref|.
"""

import numpy as np
import pytest
import torch

from nps_tpu_torch.ops.spectral import (inverse_3d_rows, mix_3d,
                                       spectral_conv_3d,
                                       spectral_conv_3d_split,
                                       spectrum_3d_rows)
from nps_tpu_torch.parallel.spatial import SpatialAxis, part

B, CI, CO, N1, N2, N3 = 2, 3, 4, 10, 8, 6
MODES = (3, 2, 2)
REL_FWD, REL_GRAD = 1e-5, 5e-5


def _rel(a, ref):
    a, ref = a.detach().double(), ref.detach().double()
    return float((a - ref).abs().max() / ref.abs().max())


def _inputs():
    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.standard_normal(
        (B, CI, N1, N2, N3)).astype(np.float32)).requires_grad_()
    ws = [torch.from_numpy(rng.standard_normal(
        (2, CI, CO, *MODES)).astype(np.float32)).requires_grad_()
          for _ in range(4)]
    dy = torch.from_numpy(rng.standard_normal(
        (B, CO, N1, N2, N3)).astype(np.float32))
    return x, ws, dy


@pytest.mark.parametrize("k", [2, 3])
def test_split_3d_conv_matches_spectral_conv_3d(k):
    """K ranks' stages, their partial spectra summed by hand, give
    ``spectral_conv_3d``'s output and, through autograd, its gradients of
    x and of weights1..4."""
    x, ws, dy = _inputs()
    ref = spectral_conv_3d(x, ws, MODES)
    ref_grads = torch.autograd.grad((ref * dy).sum(), [x, *ws])
    parts = [part(N1, k, s) for s in range(k)]
    assert k != 3 or [hi - lo for lo, hi in parts] == [3, 3, 4]
    xs = sum(spectrum_3d_rows(x[:, :, lo:hi], MODES, N1, lo)
             for lo, hi in parts)
    y = mix_3d(xs, ws, MODES)
    out = torch.cat([inverse_3d_rows(y, MODES, N1, lo, hi - lo, N2, N3)
                     for lo, hi in parts], dim=2)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert _rel(out, ref) <= REL_FWD
    grads = torch.autograd.grad((out * dy).sum(), [x, *ws])
    for name, g, r in zip(["x", "w1", "w2", "w3", "w4"], grads, ref_grads):
        assert _rel(g, r) <= REL_GRAD, name


def test_split_3d_conv_refuses_film_and_overlapping_modes():
    """FiLM in 3D raises on a split as unsplit (as in JAX), and modes
    whose low and high blocks overlap the global rows raise before any
    collective."""
    x, ws, _ = _inputs()
    axis = SpatialAxis(None, 2, 0, rows=N1)
    with pytest.raises(NotImplementedError, match="FiLM"):
        spectral_conv_3d_split(x[:, :, :5], ws, MODES,
                               film=torch.ones(B, CO, 6, 4), axis=axis)
    with pytest.raises(ValueError, match="overlap"):
        spectral_conv_3d_split(x[:, :, :5], ws, (6, 2, 2), axis=axis)
