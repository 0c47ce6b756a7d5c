"""Mode-truncated spectral convolution, the FNO/U-FNO hot op.

Counterpart of ``nps_tpu/ops/spectral.py``. The 2D path is the truncated-DFT
formulation of ``_spectral_conv_2d_dft``: a forward DFT to the retained
modes only (2*m1 low+high row modes, m2 half-spectrum column modes), a
per-mode complex ci->co mix with split real/imag weights, and an inverse
DFT with Hermitian doubling, scaled by 1/(n1*n2). It equals the reference's
rfft2 -> corner-block mix -> irfft2.

Layout: x ``[b, ci, n1, n2]`` -> ``[b, co, n1, n2]`` (NCHW). Weights are
``[weights1, weights2]``, each real ``[2, ci, co, m1, m2]`` (re, im), for
the low and the high row modes. FiLM ``[b, co, 2*m1, m2]``.

A CPU tensor takes the plain version; a CUDA tensor the kernel
``spectral_dft2d_fwd`` (``csrc/spectral_dft2d.cu``, the port of the TPU
kernel K1). The 1D and 3D paths are not ported yet and raise.

Gradients on CUDA go through :class:`SpectralConv2dFn`. The map is linear,
and its adjoint is the same three stages with the conjugate-transposed
weights: the per-mode factor h(m)/(n1 n2) of the inverse is a real scalar
per mode, so it commutes with the mix. So the input gradient is the kernel
``spectral_dft2d_bwd``: the forward's DFT stages around an adjoint mix that
reads the forward's weight pack transposed and conjugated; its spectrum
scratch holds ``dy``'s truncated spectrum G. The weight gradient per mode is
h(m)/(n1 n2) * sum_b conj(X_i) G_o, with X the forward's saved spectrum: the
kernel ``spectral_dw2d``, which writes it in the parameters' layout. Their
plain versions are :func:`spectral_dft2d_bwd_plain` and
:func:`spectral_weight_grad`. FiLM gradients on CUDA are not ported and
raise. On the CPU, autograd runs through the plain version.
"""

import numpy as np
import torch

from nps_tpu_torch import kernels


def _dft_mats_fwd(n, m):
    """Truncated forward DFT factors cos/sin(2 pi x k / n), k < m: [n, m]."""
    ang = 2.0 * np.pi * np.outer(np.arange(n), np.arange(m)) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _dft_mats_fwd_rows(n, m):
    """Forward factors for the low+high row blocks, k in [0, m) u [n-m, n):
    [n, 2m]."""
    ks = np.concatenate([np.arange(m), np.arange(n - m, n)])
    ang = 2.0 * np.pi * np.outer(np.arange(n), ks) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _dft_mats_inv_half(n, m):
    """Inverse factors for the half-spectrum axis with Hermitian doubling:
    weight 1 for k=0 (and k=n/2), 2 otherwise. [m, n]."""
    k = np.arange(m)
    w = np.where((k == 0) | ((n % 2 == 0) & (k == n // 2)), 1.0, 2.0)[:, None]
    ang = 2.0 * np.pi * np.outer(k, np.arange(n)) / n
    return ((w * np.cos(ang)).astype(np.float32),
            (w * np.sin(ang)).astype(np.float32))


def _dft_mats_inv_rows(n, m):
    """Inverse factors for the retained low+high row modes: [2m, n]."""
    ks = np.concatenate([np.arange(m), np.arange(n - m, n)])
    ang = 2.0 * np.pi * np.outer(ks, np.arange(n)) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


_TABLES = {}
_SMEM_LIMIT = 232448  # bytes of shared memory one CTA may opt in to on sm_90


def dft_tables(n1, n2, m1, m2, device):
    """The eight f32 factor tables of one 2D transform, built once on the
    host per (n1, n2, m1, m2) and kept on ``device``:
    (c2, s2) [n2, m2], (c1, s1) [n1, 2m1], (ic2, is2) [m2, n2],
    (ic1, is1) [2m1, n1]."""
    device = torch.device(device)
    key = (n1, n2, m1, m2, device)
    if key not in _TABLES:
        mats = (*_dft_mats_fwd(n2, m2), *_dft_mats_fwd_rows(n1, m1),
                *_dft_mats_inv_half(n2, m2), *_dft_mats_inv_rows(n1, m1))
        # normal tensors even when first built under inference mode, so a
        # later autograd pass through the plain version can save them
        with torch.inference_mode(False):
            _TABLES[key] = tuple(torch.from_numpy(a).to(device)
                                 for a in mats)
    return _TABLES[key]


def check_modes(modes, spatial_shape):
    """The mode-range errors: the truncated DFT would otherwise return
    finite wrong values."""
    sp = tuple(spatial_shape)
    if modes[-1] > sp[-1] // 2 + 1:
        raise ValueError(
            f"modes[-1]={modes[-1]} exceeds the half spectrum "
            f"{sp[-1] // 2 + 1} of the last spatial dim {sp[-1]}")
    for d in range(len(sp) - 1):
        if 2 * modes[d] > sp[d]:
            raise ValueError(
                f"2*modes[{d}]={2 * modes[d]} exceeds spatial dim {sp[d]}: "
                f"the low/high mode blocks overlap the spectrum")


def pack_weights_2d(weights):
    """[weights1, weights2] -> the kernel's per-mode layout
    ``[2*m1*m2, 2, ci, co]`` (mode = k*m2 + m, row modes low then high), so
    that each mode's [ci, co] slice is one contiguous read. One copy per
    weight tensor."""
    w1, w2 = (w.permute(3, 4, 0, 1, 2) for w in weights)  # [m1, m2, 2, ci, co]
    out = torch.empty((2 * w1.shape[0],) + tuple(w1.shape[1:]),
                      dtype=w1.dtype, device=w1.device)
    out[:w1.shape[0]].copy_(w1)
    out[w1.shape[0]:].copy_(w2)
    return out.reshape(-1, *out.shape[2:])


def _film_factor(film, k, m2, film_mode):
    f = film[:, :, :k, :m2].float()
    return 1.0 + f if film_mode == 0 else f


def _spectrum_plain(x, modes):
    """The truncated forward DFT of x [b, c, n1, n2]: real and imaginary
    parts, each [b, c, 2*m1, m2]."""
    m1, m2 = modes
    n1, n2 = x.shape[2:]
    c2, s2, c1, s1 = dft_tables(n1, n2, m1, m2, x.device)[:4]
    ein = torch.einsum
    x = x.float()
    # contract the half axis (y) -> m2 modes, then rows -> 2*m1
    re2 = ein("bcxy,ym->bcxm", x, c2)
    im2 = -ein("bcxy,ym->bcxm", x, s2)
    x_re = ein("bcxm,xk->bckm", re2, c1) + ein("bcxm,xk->bckm", im2, s1)
    x_im = ein("bcxm,xk->bckm", im2, c1) - ein("bcxm,xk->bckm", re2, s1)
    return x_re, x_im


def _inverse_plain(y_re, y_im, grid, modes):
    """The truncated inverse DFT of [b, c, 2*m1, m2] (real, imaginary) with
    Hermitian doubling and 1/(n1 n2): [b, c, n1, n2]."""
    (n1, n2), (m1, m2) = grid, modes
    ic2, is2, ic1, is1 = dft_tables(n1, n2, m1, m2, y_re.device)[4:]
    ein = torch.einsum
    # half axis with Hermitian doubling, then rows
    t_re = ein("bokm,my->boky", y_re, ic2) - ein("bokm,my->boky", y_im, is2)
    t_im = ein("bokm,my->boky", y_re, is2) + ein("bokm,my->boky", y_im, ic2)
    out = ein("boky,kx->boxy", t_re, ic1) - ein("boky,kx->boxy", t_im, is1)
    return out / (n1 * n2)


def spectral_conv_2d_plain(x, weights, modes, film=None, film_mode=1):
    """Plain PyTorch version of K1 (``_spectral_conv_2d_dft``)."""
    m1, m2 = modes
    x_re, x_im = _spectrum_plain(x, modes)
    ein = torch.einsum
    # complex per-mode channel mix on the stacked row blocks
    w = torch.cat([weights[0], weights[1]], dim=3)  # [2, i, o, 2m1, m2]
    wr, wi = w[0], w[1]
    y_re = ein("bikm,iokm->bokm", x_re, wr) - ein("bikm,iokm->bokm", x_im, wi)
    y_im = ein("bikm,iokm->bokm", x_re, wi) + ein("bikm,iokm->bokm", x_im, wr)
    if film is not None:
        f = _film_factor(film, 2 * m1, m2, film_mode)
        y_re = y_re * f
        y_im = y_im * f
    return _inverse_plain(y_re, y_im, x.shape[2:], modes)


def _check_kernel_fits(b, c_in, n1, n2, m1, m2, name="spectral_dft2d_fwd"):
    """Raise on a shape the kernel's design does not take: m2 above its
    largest unrolled bound (16), more threads per output row than a CTA
    has, or more shared memory per CTA than the H100 gives. ``c_in``: the
    input's channels, whose spectrum the mix stages; the backward's
    adjoint mix pads its weight rows from 16 to 20 floats. Mirrors the
    sizes in ``csrc/spectral_dft2d.cu``."""
    if m2 > 16:
        raise ValueError(f"{name} takes m2 <= 16, got {m2}")
    bound = next(v for v in (4, 8, 10, 16) if m2 <= v)
    vec = 4 if n2 % 4 == 0 else 1
    if n2 // vec > 256:
        raise ValueError(f"{name} takes rows of at most {256 * vec} points, "
                         f"got {n2}")
    k = 2 * m1
    ld = n2 + (4 if vec == 4 else 1)
    tile = 8 if b > 4 else 4 if b > 2 else b
    c_pad = -(-c_in // 16) * 16
    row = 20 if name == "spectral_dft2d_bwd" else 16
    need = 4 * max(
        -(-n1 * ld // 4) * 4                                 # forward DFT
        + 2 * (n2 * bound + n1 * k + n1 * bound),
        4 * 2 * 64 * row + 2 * c_pad * tile,                 # mix
        2 * (k * bound + k * n1 + n1 * bound))                # inverse DFT
    if need > _SMEM_LIMIT:
        raise ValueError(f"{name} needs {need} B of shared memory per CTA at "
                         f"this shape; the H100 gives {_SMEM_LIMIT}")


def spectral_dft2d_fwd(x, w_packed, modes, film=None, film_mode=1):
    """Launch the truncated-DFT spectral-conv kernel on CUDA tensors.
    ``w_packed`` is :func:`pack_weights_2d`'s layout."""
    return spectral_dft2d_fwd_spectrum(x, w_packed, modes, film,
                                       film_mode)[0]


def _check_launch(x, w_packed, modes, name, chan):
    """Raise unless ``x`` is a contiguous f32 CUDA [b, c, n1, n2] tensor and
    ``w_packed`` the contiguous f32 pack [2*m1*m2, 2, ci, co] on its device
    whose dim ``chan`` (2: ci, 3: co) is c."""
    m1, m2 = modes
    if x.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {x.device}")
    if x.dtype != torch.float32 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous f32 [b, c, n1, n2] "
                         "tensor")
    if (w_packed.device != x.device or w_packed.dtype != torch.float32
            or w_packed.ndim != 4 or not w_packed.is_contiguous()
            or tuple(w_packed.shape[:2]) != (2 * m1 * m2, 2)
            or w_packed.shape[chan] != x.shape[1]):
        dims = ["ci", "co"]
        dims[chan - 2] = str(x.shape[1])
        raise ValueError(f"w_packed must be a contiguous f32 "
                         f"[{2 * m1 * m2}, 2, {', '.join(dims)}] tensor on "
                         f"{x.device}")


def spectral_dft2d_fwd_spectrum(x, w_packed, modes, film=None, film_mode=1):
    """:func:`spectral_dft2d_fwd` that also returns the kernel's scratch
    copy of ``x``'s truncated spectrum: (out, xr, xi), xr and xi the real and
    imaginary parts, f32 [2*m1*m2, b, ci] (mode k*m2 + m)."""
    m1, m2 = modes
    _check_launch(x, w_packed, modes, "spectral_dft2d_fwd", 2)
    b, ci, n1, n2 = x.shape
    k = 2 * m1
    co = w_packed.shape[3]
    film_ptr = 0
    if film is not None:
        film = film[:, :, :k, :m2].to(torch.float32).contiguous()
        if tuple(film.shape) != (b, co, k, m2) or film.device != x.device:
            raise ValueError(f"film must be [{b}, {co}, >={k}, >={m2}] on "
                             f"{x.device}")
        film_ptr = film.data_ptr()
    _check_kernel_fits(b, ci, n1, n2, m1, m2)
    tables = dft_tables(n1, n2, m1, m2, x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    xr = torch.empty((k * m2, b, ci), **f32)
    xi = torch.empty_like(xr)
    yr = torch.empty((k * m2, b, co), **f32)
    yi = torch.empty_like(yr)
    out = torch.empty((b, co, n1, n2), **f32)
    rc = kernels.library().spectral_dft2d_fwd(
        x.data_ptr(), w_packed.data_ptr(), film_ptr, int(film_mode),
        *(t.data_ptr() for t in tables),
        xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
        out.data_ptr(), b, ci, co, n1, n2, m1, m2,
        kernels.stream_ptr(x.device))
    kernels.check(rc, "spectral_dft2d_fwd")
    kernels.launches["spectral_dft2d_fwd"] += 1
    return out, xr, xi


def spectral_dft2d_fwd_spectrum_plain(x, w_packed, modes):
    """Plain version of :func:`spectral_dft2d_fwd_spectrum` without FiLM,
    same inputs and outputs: (out, xr, xi)."""
    m1, m2 = modes
    ci, co = w_packed.shape[2:]
    w = w_packed.reshape(2 * m1, m2, 2, ci, co).permute(2, 3, 4, 0, 1)
    out = spectral_conv_2d_plain(x, [w[:, :, :, :m1], w[:, :, :, m1:]], modes)
    x_re, x_im = _spectrum_plain(x, modes)
    return out, _modes_first(x_re), _modes_first(x_im)


def spectral_dft2d_bwd(dy, w_packed, modes):
    """Launch the input-gradient kernel on CUDA tensors: dy [b, co, n1, n2]
    and the forward's pack ``w_packed`` [2*m1*m2, 2, ci, co] (read as it is)
    -> (dx [b, ci, n1, n2], gr, gi), gr and gi dy's truncated spectrum G,
    f32 [2*m1*m2, b, co]."""
    m1, m2 = modes
    _check_launch(dy, w_packed, modes, "spectral_dft2d_bwd", 3)
    b, co, n1, n2 = dy.shape
    ci = w_packed.shape[2]
    _check_kernel_fits(b, co, n1, n2, m1, m2, "spectral_dft2d_bwd")
    tables = dft_tables(n1, n2, m1, m2, dy.device)
    f32 = dict(dtype=torch.float32, device=dy.device)
    gr = torch.empty((2 * m1 * m2, b, co), **f32)
    gi = torch.empty_like(gr)
    hr = torch.empty((2 * m1 * m2, b, ci), **f32)
    hi = torch.empty_like(hr)
    dx = torch.empty((b, ci, n1, n2), **f32)
    rc = kernels.library().spectral_dft2d_bwd(
        dy.data_ptr(), w_packed.data_ptr(), *(t.data_ptr() for t in tables),
        gr.data_ptr(), gi.data_ptr(), hr.data_ptr(), hi.data_ptr(),
        dx.data_ptr(), b, ci, co, n1, n2, m1, m2,
        kernels.stream_ptr(dy.device))
    kernels.check(rc, "spectral_dft2d_bwd")
    kernels.launches["spectral_dft2d_bwd"] += 1
    return dx, gr, gi


def adjoint_mix_plain(w_packed, gr, gi):
    """The adjoint mix H_i = sum_o conj(W_io) G_o per mode, reading the
    forward's pack [M, 2, ci, co] transposed (contracting its last dim) and
    conjugated (a sign): G [M, b, co] (real, imaginary) -> H [M, b, ci]."""
    wr, wi = w_packed[:, 0], w_packed[:, 1]
    ein = torch.einsum
    hr = ein("mio,mbo->mbi", wr, gr) + ein("mio,mbo->mbi", wi, gi)
    hi = ein("mio,mbo->mbi", wr, gi) - ein("mio,mbo->mbi", wi, gr)
    return hr, hi


def _modes_first(t):
    """[b, c, 2*m1, m2] -> the kernels' scratch layout [2*m1*m2, b, c]."""
    b, c, k, m2 = t.shape
    return t.permute(2, 3, 0, 1).reshape(k * m2, b, c)


def spectral_dft2d_bwd_plain(dy, w_packed, modes):
    """Plain version of :func:`spectral_dft2d_bwd`, same inputs and
    outputs: dy's spectrum G, :func:`adjoint_mix_plain` on the forward's
    pack, and the inverse DFT."""
    m1, m2 = modes
    b = dy.shape[0]
    g_re, g_im = _spectrum_plain(dy, modes)
    gr, gi = _modes_first(g_re), _modes_first(g_im)
    hr, hi = adjoint_mix_plain(w_packed, gr, gi)
    ci = hr.shape[2]
    h_re, h_im = (h.reshape(2 * m1, m2, b, ci).permute(2, 3, 0, 1)
                  for h in (hr, hi))
    return _inverse_plain(h_re, h_im, dy.shape[2:], modes), gr, gi


def mode_scale(n1, n2, m1, m2, device):
    """h(m) / (n1 n2) per retained mode k*m2 + m, f32 [2*m1*m2]: the real
    factor the inverse DFT applies to each mode (h: Hermitian doubling).
    Built once per shape and device, like :func:`dft_tables`."""
    device = torch.device(device)
    key = ("scale", n1, n2, m1, m2, device)
    if key not in _TABLES:
        k = np.arange(m2)
        h = np.where((k == 0) | ((n2 % 2 == 0) & (k == n2 // 2)), 1.0, 2.0)
        s = np.tile(h / (n1 * n2), 2 * m1).astype(np.float32)
        with torch.inference_mode(False):
            _TABLES[key] = torch.from_numpy(s).to(device)
    return _TABLES[key]


def spectral_dw2d(xr, xi, gr, gi, scale, m1):
    """Launch the weight-gradient kernel on CUDA tensors: (dweights1,
    dweights2), each [2, ci, co, m1, m2], written once in that layout, from
    X [modes, b, ci], G [modes, b, co] (real and imaginary parts) and the
    per-mode :func:`mode_scale`. Plain version: :func:`spectral_weight_grad`."""
    if xr.device.type != "cuda":
        raise ValueError(f"spectral_dw2d takes CUDA tensors, got {xr.device}")
    modes, b, ci = xr.shape
    co = gr.shape[2]
    for t, shape in ((xr, (modes, b, ci)), (xi, (modes, b, ci)),
                     (gr, (modes, b, co)), (gi, (modes, b, co)),
                     (scale, (modes,))):
        if (t.device != xr.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"spectral_dw2d takes contiguous f32 X "
                             f"[{modes}, {b}, {ci}], G [{modes}, {b}, co] and "
                             f"scale [{modes}] on {xr.device}")
    if modes % (2 * m1):
        raise ValueError(f"{modes} modes are not 2*m1 = {2 * m1} row modes")
    m2 = modes // (2 * m1)
    dw1 = torch.empty((2, ci, co, m1, m2), dtype=torch.float32,
                      device=xr.device)
    dw2 = torch.empty_like(dw1)
    rc = kernels.library().spectral_dw2d(
        xr.data_ptr(), xi.data_ptr(), gr.data_ptr(), gi.data_ptr(),
        scale.data_ptr(), dw1.data_ptr(), dw2.data_ptr(), b, ci, co, m1, m2,
        kernels.stream_ptr(xr.device))
    kernels.check(rc, "spectral_dw2d")
    kernels.launches["spectral_dw2d"] += 1
    return dw1, dw2


def spectral_weight_grad(xr, xi, gr, gi, scale, m1):
    """Plain version of :func:`spectral_dw2d`: (dweights1, dweights2) from
    the input spectrum X [modes, b, ci], the output-gradient spectrum G
    [modes, b, co] (real and imaginary parts) and the per-mode
    :func:`mode_scale`: dW = scale * sum_b conj(X) G, as one batched product
    [X_re; X_im]^T [[G_re, G_im]; [G_im, -G_re]]."""
    a = torch.cat([xr, xi], dim=1) * scale[:, None, None]   # [M, 2b, ci]
    g = torch.cat([torch.cat([gr, gi], dim=2),
                   torch.cat([gi, -gr], dim=2)], dim=1)      # [M, 2b, 2co]
    dw = torch.bmm(a.transpose(1, 2), g)                     # [M, ci, 2co]
    modes, ci, co = dw.shape[0], dw.shape[1], dw.shape[2] // 2
    m2 = modes // (2 * m1)
    dw = dw.reshape(2 * m1, m2, ci, 2, co).permute(3, 2, 4, 0, 1)
    return dw[:, :, :, :m1].contiguous(), dw[:, :, :, m1:].contiguous()


class SpectralConv2dFn(torch.autograd.Function):
    """The 2D spectral conv on CUDA tensors with its gradient: the forward
    kernel, then ``spectral_dft2d_bwd`` on ``dy`` for the input gradient and
    ``spectral_dw2d`` for the weight gradient. The weights are packed here
    on every call, so they stay in the graph; the forward keeps that pack
    (not the weights) for the backward's adjoint mix."""

    @staticmethod
    def forward(ctx, x, weights1, weights2, modes):
        w_packed = pack_weights_2d((weights1, weights2))
        out, xr, xi = spectral_dft2d_fwd_spectrum(x, w_packed, modes)
        ctx.save_for_backward(xr, xi, w_packed)
        ctx.modes, ctx.grid = modes, tuple(x.shape[2:])
        return out

    @staticmethod
    def backward(ctx, dy):
        xr, xi, w_packed = ctx.saved_tensors
        (m1, m2), (n1, n2) = ctx.modes, ctx.grid
        dx, gr, gi = spectral_dft2d_bwd(dy.contiguous(), w_packed, ctx.modes)
        dw1 = dw2 = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw1, dw2 = spectral_dw2d(
                xr, xi, gr, gi, mode_scale(n1, n2, m1, m2, dy.device), m1)
        return (dx if ctx.needs_input_grad[0] else None), dw1, dw2, None


def spectral_conv_nd(x, weights, modes, film=None, film_mode=1,
                     num_spatial_dims=None, w_packed=None):
    """Apply a mode-truncated spectral conv to ``x`` [b, ci, *sp].

    ``w_packed`` optionally carries :func:`pack_weights_2d` of ``weights``
    for the CUDA path without gradients, so a caller can pack once instead
    of per call. Where a gradient is wanted the CUDA path takes
    :class:`SpectralConv2dFn` and ignores ``w_packed``.
    """
    nd = num_spatial_dims or (x.ndim - 2)
    modes = tuple(int(m) for m in modes)
    check_modes(modes, x.shape[2:2 + nd])
    if nd != 2:
        raise NotImplementedError(
            f"the {nd}D spectral conv is not ported yet (2D only)")
    if x.device.type == "cpu":
        return spectral_conv_2d_plain(x, weights, modes, film, film_mode)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *weights)):
        if film is not None:
            raise NotImplementedError(
                "FiLM gradients of the CUDA spectral conv are not ported "
                "yet (ROADMAP.md section 1, 'Left from P5/P6')")
        return SpectralConv2dFn.apply(x, weights[0], weights[1], modes)
    if w_packed is None:
        w_packed = pack_weights_2d(weights)
    return spectral_dft2d_fwd(x, w_packed, modes, film, film_mode)
