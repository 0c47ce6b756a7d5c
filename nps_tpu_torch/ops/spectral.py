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

Without gradients, a CPU tensor takes the plain version and a CUDA tensor
the kernel ``spectral_dft2d_fwd`` (``csrc/spectral_dft2d.cu``, the port of
the TPU kernel K1), both through the custom op
``nps_torch::spectral_dft2d_fwd``.

The 1D and 3D paths never had a TPU kernel: the JAX package computes the 1D
conv with XLA einsums and the 3D one through its FFT route. Here both run
in f32 on the CPU and on the card alike, with autograd for their backward.

The 1D path (:func:`spectral_conv_1d`, ``_spectral_conv_1d_dft``) is
``torch.einsum`` (PyTorch's matmuls run without TF32 unless a caller turns
it on): x ``[b, ci, n1]`` -> ``[b, co, n1]`` f32, with ``weights1`` real
``[2, ci, co, m1]`` and FiLM ``[b, co, m1]``. The 3D path
(:func:`spectral_conv_3d`) is ``torch.fft.rfftn``, a complex mix of the four
corner blocks of ``m1 x m2 x m3`` modes (``weights1..4``, real ``[2, ci,
co, m1, m2, m3]``: low/high first-axis modes, then low/high second-axis
modes), zeros elsewhere and ``irfftn``: x ``[b, ci, n1, n2, n3]`` ->
``[b, co, n1, n2, n3]`` f32; FiLM raises there, as in the JAX package.

``mix_impl`` (:data:`MIX_IMPLS`, the JAX package's ``"dft"``, ``"xla"`` and
its alias ``"pallas"``) names the JAX route; the port has one route per
dimension, so the three values compute the same here, and a model spec's
value is only checked (:func:`check_mix_impl`, where the spec is read).

Gradients on CUDA go through :class:`SpectralConv2dFn`. The map is linear,
and its adjoint is the same three stages with the conjugate-transposed
weights: the per-mode factor h(m)/(n1 n2) of the inverse is a real scalar
per mode, so it commutes with the mix. So the input gradient is the kernel
``spectral_dft2d_bwd``: the forward's DFT stages around an adjoint mix that
reads the forward's weight pack transposed and conjugated; its spectrum
scratch holds ``dy``'s truncated spectrum G. Like the forward it has a
large-plane variant, ``spectral_dft2d_bwd_large``, for bf16 and for the
planes and modes the resident kernels refuse (the 512² ns512 call). The
weight gradient per mode is h(m)/(n1 n2) * sum_b conj(X_i) G_o, with X the
forward's saved spectrum: the kernel ``spectral_dw2d``, which writes it in
the parameters' layout (any plane size: it reads only the spectra). Their
plain versions are :func:`spectral_dft2d_bwd_plain` and
:func:`spectral_weight_grad`. Both large-plane calls run their two DFT
stages on bf16 tensor cores (``dft_fwd_tc_kernel``, ``dft_inv_tc_kernel``)
for bf16 rows of a multiple of 8 points on 16-byte aligned planes, and as
f32 FMAs otherwise (:func:`large_stages`); the tensor-core stages read the
f32 DFT tables split into hi + lo bf16 terms (:func:`tc_tables`). With
FiLM (Y scaled by the real f per [b, co, mode]) the forward also keeps
the pre-FiLM spectrum U, and the input-gradient launch scales G by f
before its adjoint mix (so both
gradients read G f) and writes the FiLM gradient scale * Re(conj(U) G):
plain version :func:`film_grad_plain`. On the CPU, autograd runs through
the plain version.
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


def dft_tables_rows(n1, n2, m1, m2, r0, nl, device):
    """:func:`dft_tables` of the row window [r0, r0 + nl) of an n1-row plane
    (a rank's rows under spatial parallelism): the column tables whole,
    rows [r0, r0 + nl) of the forward row tables (c1, s1) and columns
    [r0, r0 + nl) of the inverse ones (ic1, is1), as contiguous copies."""
    device = torch.device(device)
    key = ("rows", n1, n2, m1, m2, r0, nl, device)
    if key not in _TABLES:
        c2, s2, c1, s1, ic2, is2, ic1, is1 = dft_tables(n1, n2, m1, m2,
                                                        device)
        w = slice(r0, r0 + nl)
        with torch.inference_mode(False):
            _TABLES[key] = (c2, s2, c1[w].contiguous(), s1[w].contiguous(),
                            ic2, is2, ic1[:, w].contiguous(),
                            is1[:, w].contiguous())
    return _TABLES[key]


def dft_tables_1d(n1, m1, device):
    """The four f32 factor tables of one 1D transform, built in float64 on
    the host once per (n1, m1) and kept on ``device``: (c1, s1) [n1, m1],
    (ic1, is1) [m1, n1] (Hermitian doubling)."""
    device = torch.device(device)
    key = ("1d", n1, m1, device)
    if key not in _TABLES:
        mats = (*_dft_mats_fwd(n1, m1), *_dft_mats_inv_half(n1, m1))
        with torch.inference_mode(False):
            _TABLES[key] = tuple(torch.from_numpy(a).to(device)
                                 for a in mats)
    return _TABLES[key]


def spectral_conv_1d(x, weights1, m1, film=None, film_mode=1):
    """The 1D mode-truncated spectral conv (``_spectral_conv_1d_dft``): the
    forward DFT truncated to ``m1`` modes, the complex ci->co mix
    ``bmi,iom->bmo`` over ``weights1`` [2, ci, co, m1], FiLM ``film[:, :,
    :m1]`` (``1 + f`` in mode 0), the half-spectrum inverse, then ``/ n1``.
    x [b, ci, n1] in any float type; every stage and the result in f32, as
    the JAX package computes it."""
    n1 = x.shape[-1]
    c1, s1, ic1, is1 = dft_tables_1d(n1, m1, x.device)
    x = x.float()
    ein = torch.einsum
    x_re = ein("bix,xm->bim", x, c1)
    x_im = -ein("bix,xm->bim", x, s1)
    wr, wi = weights1[0], weights1[1]
    y_re = ein("bim,iom->bom", x_re, wr) - ein("bim,iom->bom", x_im, wi)
    y_im = ein("bim,iom->bom", x_re, wi) + ein("bim,iom->bom", x_im, wr)
    if film is not None:
        f = film[:, :, :m1].float()
        if film_mode == 0:
            f = 1.0 + f
        y_re = y_re * f
        y_im = y_im * f
    out = ein("bom,mx->box", y_re, ic1) - ein("bom,mx->box", y_im, is1)
    return out / n1


def _refuse_film_3d(film):
    if film is not None:
        raise NotImplementedError(
            "FiLM conditioning for 3D spectral convs is not supported (as "
            "in the JAX package: the reference is inconsistent there)")


def spectral_conv_3d(x, weights, modes, film=None):
    """The 3D mode-truncated spectral conv (the JAX package's FFT route):
    ``rfftn`` over the three spatial axes, the complex ci->co mix of each
    corner block of ``modes`` (low/high first-axis modes x low/high
    second-axis modes, the low third-axis half-spectrum modes) with its
    weights of ``weights`` [4 x [2, ci, co, m1, m2, m3]], zeros elsewhere,
    ``irfftn`` to the input's size. x [b, ci, n1, n2, n3] in any float
    type; the result in f32."""
    _refuse_film_3d(film)
    m1, m2, m3 = modes
    b, _, n1, n2, n3 = x.shape
    xf = torch.fft.rfftn(x.float(), dim=(2, 3, 4))
    rows = (slice(0, m1), slice(n1 - m1, n1))
    cols = (slice(0, m2), slice(n2 - m2, n2))
    # weights1..4: (low, low), (high, low), (low, high), (high, high)
    blocks = [(r, c) for c in cols for r in rows]
    outs = [torch.einsum("bixyz,ioxyz->boxyz", xf[:, :, r, c, :m3],
                         torch.complex(w[0], w[1]))
            for (r, c), w in zip(blocks, weights)]
    co = outs[0].shape[1]
    z1 = xf.new_zeros((b, co, n1 - 2 * m1, m2, m3))
    left = torch.cat([outs[0], z1, outs[1]], dim=2)
    right = torch.cat([outs[2], z1, outs[3]], dim=2)
    z2 = xf.new_zeros((b, co, n1, n2 - 2 * m2, m3))
    plane = torch.cat([left, z2, right], dim=3)
    z3 = xf.new_zeros((b, co, n1, n2, n3 // 2 + 1 - m3))
    return torch.fft.irfftn(torch.cat([plane, z3], dim=4), s=(n1, n2, n3),
                            dim=(2, 3, 4))


# ---- the 3D conv on a row split ---------------------------------------------
# As nps_tpu/parallel/spatial.py splits the 2D transform: the third and second
# axes are local, so a rank takes rfft / fft over them, contracts its rows
# with the row window of the first axis' DFT, and the partial spectra are
# summed over the x group; the mix then runs on the whole spectrum, and the
# inverse comes back to the local rows only. No FFT transpose is needed.


def dft_rows_3d(n1, m1, r0, nl, device):
    """The complex row tables of the window [r0, r0 + nl) of an n1-row
    axis, k in [0, m1) u [n1 - m1, n1): the forward exp(-2 pi i k r / n1)
    [nl, 2 m1] and the inverse exp(+2 pi i k r / n1) / n1 [2 m1, nl],
    built in float64 on the host once per window and kept on ``device``."""
    device = torch.device(device)
    key = ("rows3d", n1, m1, r0, nl, device)
    if key not in _TABLES:
        ks = np.concatenate([np.arange(m1), np.arange(n1 - m1, n1)])
        ang = 2.0 * np.pi * np.outer(np.arange(r0, r0 + nl), ks) / n1
        fwd = np.exp(-1j * ang).astype(np.complex64)
        inv = (np.exp(1j * ang.T) / n1).astype(np.complex64)
        with torch.inference_mode(False):
            _TABLES[key] = (torch.from_numpy(fwd).to(device),
                            torch.from_numpy(inv).to(device))
    return _TABLES[key]


def spectrum_3d_rows(x, modes, n1, r0):
    """The partial spectrum of rows [r0, r0 + nl) of an n1-row field x [b,
    ci, nl, n2, n3]: ``rfft`` over the third axis (m3 modes), ``fft`` over
    the second (its m2 low and m2 high columns), the row window's forward
    table over the rows. Complex [b, ci, 2 m1, 2 m2, m3]; summed over the
    ranks it is the whole field's retained spectrum."""
    m1, m2, m3 = modes
    n2 = x.shape[3]
    fwd, _ = dft_rows_3d(n1, m1, r0, x.shape[2], x.device)
    xf = torch.fft.fft(torch.fft.rfft(x.float(), dim=4)[..., :m3], dim=3)
    xf = torch.cat([xf[:, :, :, :m2], xf[:, :, :, n2 - m2:]], dim=3)
    return torch.einsum("bixyz,xk->bikyz", xf, fwd)


def mix_3d(xs, weights, modes):
    """The complex ci->co mix of each corner block of the retained spectrum
    xs [b, ci, 2 m1, 2 m2, m3] with ``weights1..4`` [2, ci, co, m1, m2, m3]
    in :func:`spectral_conv_3d`'s order: (low, low), (high, low), (low,
    high), (high, high). Complex [b, co, 2 m1, 2 m2, m3]."""
    m1, m2, _ = modes
    rows = (slice(0, m1), slice(m1, 2 * m1))
    cols = (slice(0, m2), slice(m2, 2 * m2))
    outs = [torch.einsum("bixyz,ioxyz->boxyz", xs[:, :, r, c],
                         torch.complex(w[0], w[1]))
            for (r, c), w in zip([(r, c) for c in cols for r in rows],
                                 weights)]
    return torch.cat([torch.cat(outs[:2], dim=2), torch.cat(outs[2:], dim=2)],
                     dim=3)


def inverse_3d_rows(y, modes, n1, r0, nl, n2, n3):
    """Rows [r0, r0 + nl) of the inverse of the retained spectrum y [b, co,
    2 m1, 2 m2, m3]: the row window's inverse table, then ``ifft`` over the
    second axis and ``irfft`` (n = n3) over the third, which together are
    ``irfftn``'s normalisation and its half spectrum. f32 [b, co, nl, n2,
    n3]."""
    m1, m2, m3 = modes
    _, inv = dft_rows_3d(n1, m1, r0, nl, y.device)
    y = torch.einsum("bokyz,kx->boxyz", y, inv)
    b, co = y.shape[:2]
    z2 = y.new_zeros((b, co, nl, n2 - 2 * m2, m3))
    y = torch.fft.ifft(torch.cat([y[:, :, :, :m2], z2, y[:, :, :, m2:]],
                                 dim=3), dim=3)
    z3 = y.new_zeros((b, co, nl, n2, n3 // 2 + 1 - m3))
    return torch.fft.irfft(torch.cat([y, z3], dim=4), n=n3, dim=4)


def spectral_conv_3d_split(x, weights, modes, film=None, axis=None):
    """:func:`spectral_conv_3d` of a row-split field x [b, ci, nl, n2, n3]
    (``axis``: the x group, its ``rows`` the field's n1): the local rows'
    partial spectrum, its sum over the x group
    (:func:`~nps_tpu_torch.parallel.spatial.spatial_sum`, whose backward
    sums the gradient over the group too), the mix, the inverse to the local
    rows. Autograd gives the backward, on either device; f32 out."""
    from nps_tpu_torch.parallel.spatial import spatial_sum

    _refuse_film_3d(film)
    n1, (_, _, nl, n2, n3) = axis.rows, x.shape
    r0 = axis.part(n1)[0]
    check_modes(modes, (n1, n2, n3))
    xs = torch.view_as_complex(spatial_sum(
        torch.view_as_real(spectrum_3d_rows(x, modes, n1, r0)), axis))
    return inverse_3d_rows(mix_3d(xs, weights, modes), modes, n1, r0, nl,
                           n2, n3)


# the JAX package's mix_impl values; "pallas" is its alias of "dft"
MIX_IMPLS = ("dft", "xla", "pallas")


def check_mix_impl(mix_impl):
    """Raise on a ``mix_impl`` outside :data:`MIX_IMPLS`."""
    if mix_impl not in MIX_IMPLS:
        raise ValueError(f"mix_impl must be one of {MIX_IMPLS}, got "
                         f"{mix_impl!r}")
    return mix_impl


def _bf16_round(a):
    """f32 values -> the nearest bf16 values (ties to even, as
    ``__floats2bfloat162_rn``), as f32."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def split_bf16(a):
    """An f32 table as two bf16 terms: hi = bf16(a), lo = bf16(a - hi), each
    as f32; hi + lo holds a to ~2^-17 of its magnitude."""
    hi = _bf16_round(a)
    return hi, _bf16_round(np.asarray(a, dtype=np.float32) - hi)


def _pack_pairs(e0, e1):
    """Two arrays of bf16 values (as f32) -> uint32 words, e0 in the low
    half: the element order of an mma fragment register."""
    return ((e0.view(np.uint32) >> np.uint32(16))
            | (e1.view(np.uint32) & np.uint32(0xFFFF0000)))


_LANE_G, _LANE_T = np.arange(32) // 4, np.arange(32) % 4


def frag_a(a):
    """A [16 M, 16 S] of bf16 values -> its mma.m16n8k16 A fragments
    [M, S, 32 lanes, 4] uint32: per lane g = lane // 4, t = lane % 4, a0
    (row g, cols 2t, 2t+1), a1 (row g+8), a2 (row g, cols 2t+8, 2t+9), a3
    (row g+8, cols 2t+8, 2t+9)."""
    m, s = a.shape[0] // 16, a.shape[1] // 16
    blk = a.reshape(m, 16, s, 16).transpose(0, 2, 1, 3)
    g, t = _LANE_G, _LANE_T
    return np.stack([_pack_pairs(blk[:, :, g + dr, 2 * t + dc],
                                 blk[:, :, g + dr, 2 * t + dc + 1])
                     for dr, dc in ((0, 0), (8, 0), (0, 8), (8, 8))], -1)


def frag_b(b):
    """B [16 S, 8 N] of bf16 values -> its mma.m16n8k16 B fragments
    [S, N, 32 lanes, 2] uint32: b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8,
    2t+9, col g)."""
    s, n = b.shape[0] // 16, b.shape[1] // 8
    blk = b.reshape(s, 16, n, 8).transpose(0, 2, 1, 3)
    g, t = _LANE_G, _LANE_T
    return np.stack([_pack_pairs(blk[:, :, 2 * t + dk, g],
                                 blk[:, :, 2 * t + dk + 1, g])
                     for dk in (0, 8)], -1)


def tc_mt(m2):
    """The tensor-core stages' 16-row tiles of mode rows (the kernels'
    compile-time bound MT): the 2*m2 (cos | sin) rows in groups of 8."""
    return 3 if m2 <= 12 else 5 if m2 <= 20 else 8


def tc_tables_np(n1, n2, m1, m2, rows=None):
    """The tensor-core stages' tables (``csrc/spectral_dft2d.cu``:
    TcTables) from :func:`dft_tables`' f32 factors split by
    :func:`split_bf16`, in mma fragment order (uint32 words):

    - ty [ceil(n2/64)*4, MT, 32, 4]: the y pass's A, per 16-row tile the hi
      (rows 0-7) and lo (rows 8-15) terms of 8 of the (c2 | s2)^T mode rows;
    - te [tiles*16, NT, 32, 4]: the x pass's B, (c1 | s1) [rows, 2*2m1] in
      n-tiles of 8, {b0, b1} hi then lo;
    - ta [tiles*16, KS1, 2, 32, 4]: the row pass's A, (ic1 | is1)^T [rows,
      2*2m1], hi then lo;
    - tb [n2/8, KSZ, 32, 4]: the column pass's B, E = (ic2 ; -is2)
      [2*m2, n2] padded to 16 KSZ = 8 MT (+ 8) rows, {b0, b1} hi then lo.

    Rows are padded to whole row tiles (256) and columns to whole chunks (64),
    with zeros; n2 % 8 == 0. With ``rows`` = (r0, nl) the row tables are
    those of the window [r0, r0 + nl) (:func:`dft_tables_rows`)."""
    if n2 % 8:
        raise ValueError(f"the tensor-core stages take n2 % 8 == 0, got {n2}")
    c2, s2, c1, s1, ic2, is2, ic1, is1 = (
        *_dft_mats_fwd(n2, m2), *_dft_mats_fwd_rows(n1, m1),
        *_dft_mats_inv_half(n2, m2), *_dft_mats_inv_rows(n1, m1))
    if rows is not None:
        w = slice(rows[0], rows[0] + rows[1])
        c1, s1, ic1, is1 = c1[w], s1[w], ic1[:, w], is1[:, w]
        n1 = rows[1]
    mt, k = tc_mt(m2), 2 * m1
    n1p = -(-n1 // _LARGE_ROWS) * _LARGE_ROWS
    n2p = -(-n2 // 64) * 64
    nt, ks1, ksz = -(-2 * k // 8), -(-2 * k // 16), (mt + 1) // 2
    f = np.zeros((8 * mt, n2p), np.float32)
    f[:m2, :n2], f[m2:2 * m2, :n2] = c2.T, s2.T
    hi, lo = split_bf16(f)
    ay = np.stack([hi.reshape(mt, 8, n2p), lo.reshape(mt, 8, n2p)],
                  1).reshape(16 * mt, n2p)
    ty = frag_a(ay).transpose(1, 0, 2, 3)
    e = np.zeros((n1p, 8 * nt), np.float32)
    e[:n1, :k], e[:n1, k:2 * k] = c1, s1
    hi, lo = split_bf16(e)
    te = np.concatenate([frag_b(hi), frag_b(lo)], -1)
    g = np.zeros((n1p, 16 * ks1), np.float32)
    g[:n1, :k], g[:n1, k:2 * k] = ic1.T, is1.T
    hi, lo = split_bf16(g)
    ta = np.stack([frag_a(hi), frag_a(lo)], 2)
    e2 = np.zeros((16 * ksz, n2), np.float32)
    e2[:m2], e2[m2:2 * m2] = ic2, -is2
    hi, lo = split_bf16(e2)
    tb = np.concatenate([frag_b(hi), frag_b(lo)], -1).transpose(1, 0, 2, 3)
    return tuple(np.ascontiguousarray(t) for t in (ty, te, ta, tb))


def tc_tables(n1, n2, m1, m2, device, rows=None):
    """:func:`tc_tables_np` as int32 tensors on ``device``, built once per
    (n1, n2, m1, m2, device, rows) in the cache of :func:`dft_tables`."""
    device = torch.device(device)
    key = ("tc", n1, n2, m1, m2, device, rows)
    if key not in _TABLES:
        with torch.inference_mode(False):
            _TABLES[key] = tuple(torch.from_numpy(t.view(np.int32)).to(device)
                                 for t in tc_tables_np(n1, n2, m1, m2, rows))
    return _TABLES[key]


def large_stages(dtype, n2, *ptrs):
    """The DFT stages a large-plane call runs, as ``csrc/spectral_dft2d.cu``
    (tc_stages) chooses them, by type and alignment alone: "tensor" (bf16
    tensor-core products) for bf16 rows of a multiple of 8 points whose
    plane pointers (x and out, or dy and dx) are all 16-byte aligned, else
    "fma" (f32 FMAs on the CUDA cores)."""
    if (dtype == torch.bfloat16 and n2 % 8 == 0
            and all(p % 16 == 0 for p in ptrs)):
        return "tensor"
    return "fma"


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


def _tables(grid, modes, device, rows):
    """The tables of the plane ``grid`` (its local rows and n2), whole or
    (``rows`` = (n1, r0): rows [r0, r0 + local rows) of an n1-row plane)
    the window's."""
    (nl, n2), (m1, m2) = grid, modes
    if rows is None:
        return dft_tables(nl, n2, m1, m2, device)
    return dft_tables_rows(rows[0], n2, m1, m2, rows[1], nl, device)


def _spectrum_plain(x, modes, rows=None):
    """The truncated forward DFT of x [b, c, n1, n2]: real and imaginary
    parts, each [b, c, 2*m1, m2]. With ``rows`` = (n1, r0), x holds rows
    [r0, r0 + its rows) of an n1-row plane, and the result is their share
    of the plane's spectrum (stage A of the row split)."""
    c2, s2, c1, s1 = _tables(x.shape[2:], modes, x.device, rows)[:4]
    ein = torch.einsum
    x = x.float()
    # contract the half axis (y) -> m2 modes, then rows -> 2*m1
    re2 = ein("bcxy,ym->bcxm", x, c2)
    im2 = -ein("bcxy,ym->bcxm", x, s2)
    x_re = ein("bcxm,xk->bckm", re2, c1) + ein("bcxm,xk->bckm", im2, s1)
    x_im = ein("bcxm,xk->bckm", im2, c1) - ein("bcxm,xk->bckm", re2, s1)
    return x_re, x_im


def _inverse_plain(y_re, y_im, grid, modes, rows=None):
    """The truncated inverse DFT of [b, c, 2*m1, m2] (real, imaginary) with
    Hermitian doubling and 1/(n1 n2): [b, c, n1, n2]. With ``rows`` = (n1,
    r0), ``grid`` is (local rows, n2) and the result rows [r0, r0 + local
    rows) of the n1-row plane's inverse (stage B of the row split)."""
    n1, n2 = grid if rows is None else (rows[0], grid[1])
    ic2, is2, ic1, is1 = _tables(grid, modes, y_re.device, rows)[4:]
    ein = torch.einsum
    # half axis with Hermitian doubling, then rows
    t_re = ein("bokm,my->boky", y_re, ic2) - ein("bokm,my->boky", y_im, is2)
    t_im = ein("bokm,my->boky", y_re, is2) + ein("bokm,my->boky", y_im, ic2)
    out = ein("boky,kx->boxy", t_re, ic1) - ein("boky,kx->boxy", t_im, is1)
    return out / (n1 * n2)


def _mix_plain(x_re, x_im, weights, modes, film=None, film_mode=1):
    """The complex per-mode channel mix of the spectrum [b, ci, 2*m1, m2]
    (real, imaginary) on the stacked row blocks, then FiLM: [b, co, ...]."""
    m1, m2 = modes
    ein = torch.einsum
    w = torch.cat([weights[0], weights[1]], dim=3)  # [2, i, o, 2m1, m2]
    wr, wi = w[0], w[1]
    y_re = ein("bikm,iokm->bokm", x_re, wr) - ein("bikm,iokm->bokm", x_im, wi)
    y_im = ein("bikm,iokm->bokm", x_re, wi) + ein("bikm,iokm->bokm", x_im, wr)
    if film is not None:
        f = _film_factor(film, 2 * m1, m2, film_mode)
        y_re = y_re * f
        y_im = y_im * f
    return y_re, y_im


def spectral_conv_2d_plain(x, weights, modes, film=None, film_mode=1):
    """Plain PyTorch version of K1 (``_spectral_conv_2d_dft``): every stage
    in f32, the result in ``x``'s type (f32 or bf16), as the kernel
    rounds it."""
    y_re, y_im = _mix_plain(*_spectrum_plain(x, modes), weights, modes, film,
                            film_mode)
    return _inverse_plain(y_re, y_im, x.shape[2:], modes).to(x.dtype)


def spectral_conv_2d_packed_plain(x, w_packed, modes, film=None,
                                  film_mode=1):
    """:func:`spectral_conv_2d_plain` on the weight pack
    [2*m1*m2, 2, ci, co] of :func:`pack_weights_2d`."""
    m1, m2 = modes
    ci, co = w_packed.shape[2:]
    w = w_packed.reshape(2 * m1, m2, 2, ci, co).permute(2, 3, 4, 0, 1)
    return spectral_conv_2d_plain(x, [w[:, :, :, :m1], w[:, :, :, m1:]],
                                  modes, film, film_mode)


# the large-plane variant's limits, as ``csrc/spectral_dft2d.cu`` sizes it:
# rows per forward CTA, rows per inverse CTA, the largest m2 bound, the
# threads of an inverse CTA (4 outputs of a row each)
_LARGE_ROWS, _LARGE_INV_ROWS, _LARGE_M2, _LARGE_THREADS = 256, 128, 32, 256


def _check_kernel_fits(b, c_in, n1, n2, m1, m2, name="spectral_dft2d_fwd",
                       bf16=False, c_out=None):
    """The kernel variant that takes this shape, "resident" or "large";
    raise on a shape that neither takes. ``name`` is the forward
    (``spectral_dft2d_fwd``) or the input gradient (``spectral_dft2d_bwd``).
    ``c_in``: the channels whose spectrum the mix stages (the forward's
    input, or for the backward dy's, the forward's output); ``c_out``: the
    stage's output channels, for the large variant's grid. The resident
    kernels (f32) hold a plane and its tables in shared memory and unroll m2
    up to 16; the large-plane variant (f32 or bf16) tiles rows, columns and
    tables and takes m2 up to 32 and rows up to 1024 points. The backward
    chooses as the forward does; its adjoint mix pads its weight rows from
    16 to 20 floats. The choice depends only on the shape and the type,
    never on a failure. Mirrors the sizes in ``csrc/spectral_dft2d.cu``."""
    k = 2 * m1
    tile = 8 if b > 4 else 4 if b > 2 else b
    c_pad = -(-c_in // 16) * 16
    row = 20 if name == "spectral_dft2d_bwd" else 16
    mix = 4 * (4 * 2 * 64 * row + 2 * c_pad * tile)
    if mix > _SMEM_LIMIT:
        raise ValueError(f"{name}'s mix needs {mix} B of shared memory per "
                         f"CTA for {c_in} channels; the H100 gives "
                         f"{_SMEM_LIMIT}")
    why = None
    if bf16:
        why = "bf16 input"
    elif m2 > 16:
        why = f"m2 = {m2} > 16"
    else:
        bound = next(v for v in (4, 8, 10, 16) if m2 <= v)
        vec = 4 if n2 % 4 == 0 else 1
        ld = n2 + (4 if vec == 4 else 1)
        need = 4 * max(
            -(-n1 * ld // 4) * 4                              # forward DFT
            + 2 * (n2 * bound + n1 * k + n1 * bound),
            2 * (k * bound + k * n1 + n1 * bound))             # inverse DFT
        if n2 // vec > 256:
            why = f"rows of {n2} points"
        elif need > _SMEM_LIMIT:
            why = f"{need} B of shared memory per CTA"
    if why is None:
        return "resident"
    if m2 > _LARGE_M2:
        raise ValueError(f"{name} takes m2 <= {_LARGE_M2}, got {m2}")
    if -(-n2 // 4) > _LARGE_THREADS:
        raise ValueError(f"{name} takes rows of at most "
                         f"{4 * _LARGE_THREADS} points, got {n2}")
    inv = 8 * (k + _LARGE_INV_ROWS) * m2
    if inv > _SMEM_LIMIT:
        raise ValueError(f"{name}'s inverse needs {inv} B of shared memory "
                         f"per CTA at {k} row modes")
    if b * max(c_in, c_out or 0) > 65535:
        raise ValueError(f"{name} takes at most 65535 planes a call, got "
                         f"{b} x {max(c_in, c_out or 0)}")
    if bf16 and n2 % 8 == 0:   # the tensor-core stages may take it
        need = max(_tc_smem(k, m2))
        if need > _SMEM_LIMIT:
            raise ValueError(f"{name}'s tensor-core stages need {need} B of "
                             f"shared memory per CTA at {k} row modes")
    return "large"


# the tensor-core stages' sizes, as ``csrc/spectral_dft2d.cu`` sets them:
# y columns per staged chunk, its ring depth, the column pass's n-tiles per
# table ring slot and that ring's depth
_TC_KC, _TC_STAGES, _TC_NG, _TC_INV_STAGES = 64, 2, 4, 3


def _tc_smem(k, m2):
    """Shared memory per CTA of the forward and the inverse tensor-core
    stage (tc_fwd_smem, tc_inv_smem) at 2*m1 = k row modes."""
    mt = tc_mt(m2)
    i = (mt + 1) // 2
    frag = 32 * 16                      # one uint4 fragment per lane
    ring = _TC_STAGES * (_LARGE_ROWS * _TC_KC * 2 + mt * (_TC_KC // 16) * frag)
    fwd = (max(ring, i * 16 * 2 * frag + 4 * 16 * i * 8 * -(-2 * k // 8))
           + 1024 + 8 * _TC_STAGES)   # alignment slack, the barriers
    inv = (_TC_INV_STAGES * _TC_NG * i * frag + -(-2 * k // 16) * mt * frag
           + _LARGE_ROWS * (8 * _TC_NG + 8) * 2 + 4 * 2 * k * m2)
    return fwd, inv


def spectral_dft2d_fwd(x, w_packed, modes, film=None, film_mode=1):
    """Launch the truncated-DFT spectral-conv kernel on CUDA tensors.
    ``w_packed`` is :func:`pack_weights_2d`'s layout."""
    return spectral_dft2d_fwd_spectrum(x, w_packed, modes, film,
                                       film_mode)[0]


def _check_launch(x, w_packed, modes, name, chan, types=(torch.float32,)):
    """Raise unless ``x`` is a contiguous [b, c, n1, n2] CUDA tensor of one
    of ``types`` and ``w_packed`` the contiguous f32 pack
    [2*m1*m2, 2, ci, co] on its device whose dim ``chan`` (2: ci, 3: co) is
    c."""
    m1, m2 = modes
    if x.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {x.device}")
    if x.dtype not in types or x.ndim != 4 or not x.is_contiguous():
        kinds = " or ".join(str(t).replace("torch.", "") for t in types)
        raise ValueError(f"{name} takes a contiguous {kinds} [b, c, n1, n2] "
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


def spectral_dft2d_fwd_spectrum(x, w_packed, modes, film=None, film_mode=1,
                                keep_y=False):
    """:func:`spectral_dft2d_fwd` that also returns the kernel's scratch
    copy of ``x``'s truncated spectrum: (out, xr, xi), xr and xi the real and
    imaginary parts, f32 [2*m1*m2, b, ci] (mode k*m2 + m). With ``film`` and
    ``keep_y`` it returns (out, xr, xi, ur, ui): also the mix's pre-FiLM
    spectrum U, f32 [2*m1*m2, b, co], which the FiLM gradient needs.

    ``x`` is f32 or bf16, and ``out`` has its type; the spectra, the pack
    and every sum are f32. The variant follows :func:`_check_kernel_fits`:
    the resident kernels count their launches under
    ``spectral_dft2d_fwd``, the large-plane variant under
    ``spectral_dft2d_fwd_large``; its DFT stages follow
    :func:`large_stages`."""
    m1, m2 = modes
    _check_launch(x, w_packed, modes, "spectral_dft2d_fwd", 2,
                  (torch.float32, torch.bfloat16))
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
    bf16 = x.dtype == torch.bfloat16
    variant = _check_kernel_fits(b, ci, n1, n2, m1, m2, bf16=bf16, c_out=co)
    tables = dft_tables(n1, n2, m1, m2, x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    xr = torch.empty((k * m2, b, ci), **f32)
    xi = torch.empty_like(xr)
    yr = torch.empty((k * m2, b, co), **f32)
    yi = torch.empty_like(yr)
    keep = film is not None and keep_y
    ur, ui = ((torch.empty_like(yr), torch.empty_like(yr)) if keep
              else (None, None))
    out = torch.empty((b, co, n1, n2), dtype=x.dtype, device=x.device)
    lib = kernels.library()
    if variant == "resident":
        rc = lib.spectral_dft2d_fwd(
            x.data_ptr(), w_packed.data_ptr(), film_ptr, int(film_mode),
            *(t.data_ptr() for t in tables),
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            _ptr(ur), _ptr(ui), out.data_ptr(), b, ci, co, n1, n2, m1, m2,
            kernels.stream_ptr(x.device))
        kernels.check(rc, "spectral_dft2d_fwd")
        kernels.launches["spectral_dft2d_fwd"] += 1
    else:
        pr, pi = _row_tile_partials(n1, k * m2, b, ci, x.device)
        tc = _tc_args(x, out, modes)
        rc = lib.spectral_dft2d_fwd_large(
            x.data_ptr(), w_packed.data_ptr(), film_ptr, int(film_mode),
            *(t.data_ptr() for t in tables), *tc, _ptr(pr), _ptr(pi),
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            _ptr(ur), _ptr(ui), out.data_ptr(), b, ci, co, n1, n2, m1, m2,
            int(bf16), kernels.stream_ptr(x.device))
        kernels.check(rc, "spectral_dft2d_fwd_large")
        kernels.launches["spectral_dft2d_fwd_large"] += 1
    return (out, xr, xi, ur, ui) if keep else (out, xr, xi)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _tc_args(x, out, modes):
    """The tensor-core stages' table pointers for a large-plane call on x
    (or dy) into out (or dx), or four nulls where :func:`large_stages`
    gives the FMA stages."""
    if large_stages(x.dtype, x.shape[-1], x.data_ptr(),
                    out.data_ptr()) == "fma":
        return (0,) * 4
    n1, n2 = x.shape[2:]
    return tuple(t.data_ptr() for t in tc_tables(n1, n2, *modes, x.device))


def _row_tile_partials(n1, modes, b, c, device):
    """The large-plane DFT's scratch for its row tiles' partial spectra,
    f32 [tiles, modes, b, c] (real and imaginary parts); (None, None) when
    the rows take one tile."""
    tiles = -(-n1 // _LARGE_ROWS)
    if tiles == 1:
        return None, None
    pr = torch.empty((tiles, modes, b, c), dtype=torch.float32,
                     device=device)
    return pr, torch.empty_like(pr)


def spectral_dft2d_fwd_spectrum_plain(x, w_packed, modes, film=None,
                                      film_mode=1, keep_y=False):
    """Plain version of :func:`spectral_dft2d_fwd_spectrum`, same inputs
    and outputs."""
    out = spectral_conv_2d_packed_plain(x, w_packed, modes, film, film_mode)
    x_re, x_im = _spectrum_plain(x, modes)
    xr, xi = _modes_first(x_re), _modes_first(x_im)
    if film is None or not keep_y:
        return out, xr, xi
    wr, wi = w_packed[:, 0], w_packed[:, 1]
    ein = torch.einsum
    ur = ein("mbi,mio->mbo", xr, wr) - ein("mbi,mio->mbo", xi, wi)
    ui = ein("mbi,mio->mbo", xr, wi) + ein("mbi,mio->mbo", xi, wr)
    return out, xr, xi, ur, ui


def _check_film_bwd(film, u, scale, b, co, modes, device):
    m1, m2 = modes
    n = 2 * m1 * m2
    checks = [("film", film, (b, co, 2 * m1, m2))]
    if u is not None:
        checks += [("ur", u[0], (n, b, co)), ("ui", u[1], (n, b, co)),
                   ("scale", scale, (n,))]
    for name, t, shape in checks:
        if (t.device != device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"spectral_dft2d_bwd: {name} must be a "
                             f"contiguous f32 {list(shape)} tensor on "
                             f"{device}")


def spectral_dft2d_bwd(dy, w_packed, modes, film=None, film_mode=1, u=None,
                       scale=None):
    """Launch the input-gradient kernel on CUDA tensors: dy [b, co, n1, n2]
    (f32 or bf16) and the forward's pack ``w_packed`` [2*m1*m2, 2, ci, co]
    (read as it is) -> (dx [b, ci, n1, n2] in dy's type, gr, gi), gr and gi
    dy's truncated spectrum G, f32 [2*m1*m2, b, co]. With the forward's
    ``film`` [b, co, 2*m1, m2] (and ``film_mode``), its pre-FiLM spectrum
    ``u`` = (ur, ui) and the per-mode :func:`mode_scale`, it returns (dx,
    gr, gi, dfilm): G scaled by the FiLM factor, and dfilm [b, co, 2*m1,
    m2]. Without ``u`` (film needs no gradient) dfilm is None and only G is
    scaled. The variant follows :func:`_check_kernel_fits`: the resident
    kernels count their launches under ``spectral_dft2d_bwd``, the
    large-plane variant (every bf16 call, and the f32 planes and modes the
    resident kernels refuse) under ``spectral_dft2d_bwd_large``; its DFT
    stages follow :func:`large_stages`."""
    m1, m2 = modes
    _check_launch(dy, w_packed, modes, "spectral_dft2d_bwd", 3,
                  (torch.float32, torch.bfloat16))
    b, co, n1, n2 = dy.shape
    ci = w_packed.shape[2]
    bf16 = dy.dtype == torch.bfloat16
    variant = _check_kernel_fits(b, co, n1, n2, m1, m2, "spectral_dft2d_bwd",
                                 bf16=bf16, c_out=ci)
    tables = dft_tables(n1, n2, m1, m2, dy.device)
    f32 = dict(dtype=torch.float32, device=dy.device)
    k = 2 * m1
    gr = torch.empty((k * m2, b, co), **f32)
    gi = torch.empty_like(gr)
    hr = torch.empty((k * m2, b, ci), **f32)
    hi = torch.empty_like(hr)
    dx = torch.empty((b, ci, n1, n2), dtype=dy.dtype, device=dy.device)
    dfilm = ur = ui = None
    if film is not None:
        _check_film_bwd(film, u, scale, b, co, modes, dy.device)
        if u is not None:
            ur, ui = u
            dfilm = torch.empty_like(film)
    film_args = (_ptr(film), int(film_mode), _ptr(ur), _ptr(ui), _ptr(scale),
                 _ptr(dfilm), *(t.data_ptr() for t in tables))
    lib = kernels.library()
    if variant == "resident":
        rc = lib.spectral_dft2d_bwd(
            dy.data_ptr(), w_packed.data_ptr(), *film_args,
            gr.data_ptr(), gi.data_ptr(), hr.data_ptr(), hi.data_ptr(),
            dx.data_ptr(), b, ci, co, n1, n2, m1, m2,
            kernels.stream_ptr(dy.device))
        kernels.check(rc, "spectral_dft2d_bwd")
        kernels.launches["spectral_dft2d_bwd"] += 1
    else:
        pr, pi = _row_tile_partials(n1, k * m2, b, co, dy.device)
        rc = lib.spectral_dft2d_bwd_large(
            dy.data_ptr(), w_packed.data_ptr(), *film_args,
            *_tc_args(dy, dx, modes), _ptr(pr),
            _ptr(pi), gr.data_ptr(), gi.data_ptr(), hr.data_ptr(),
            hi.data_ptr(), dx.data_ptr(), b, ci, co, n1, n2, m1, m2,
            int(bf16), kernels.stream_ptr(dy.device))
        kernels.check(rc, "spectral_dft2d_bwd_large")
        kernels.launches["spectral_dft2d_bwd_large"] += 1
    return (dx, gr, gi) if film is None else (dx, gr, gi, dfilm)


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


def film_grad_plain(gr, gi, ur, ui, film, film_mode, scale):
    """Plain version of the backward's FiLM stage (``film_bwd_kernel``):
    from G and the pre-FiLM U ([modes, b, co], real and imaginary parts),
    the forward's film [b, co, 2*m1, m2] and :func:`mode_scale`, return
    (G f, dfilm), with f = film (mode 1) or 1 + film (mode 0) and
    dfilm = scale * (U_re G_re + U_im G_im) in film's layout; dfilm is None
    without U."""
    f = _modes_first(_film_factor(film, film.shape[2], film.shape[3],
                                  film_mode))
    if ur is None:
        return gr * f, gi * f, None
    d = (ur * gr + ui * gi) * scale[:, None, None]
    b, co, k, m2 = film.shape
    dfilm = d.reshape(k, m2, b, co).permute(2, 3, 0, 1).contiguous()
    return gr * f, gi * f, dfilm


def spectral_dft2d_bwd_plain(dy, w_packed, modes, film=None, film_mode=1,
                             u=None, scale=None):
    """Plain version of :func:`spectral_dft2d_bwd`, same inputs and
    outputs: dy's spectrum G, with FiLM :func:`film_grad_plain`,
    :func:`adjoint_mix_plain` on the forward's pack, and the inverse DFT,
    all in f32; dx in dy's type."""
    m1, m2 = modes
    b = dy.shape[0]
    g_re, g_im = _spectrum_plain(dy, modes)
    gr, gi = _modes_first(g_re), _modes_first(g_im)
    if film is not None:
        gr, gi, dfilm = film_grad_plain(gr, gi, *(u or (None, None)), film,
                                        film_mode, scale)
    hr, hi = adjoint_mix_plain(w_packed, gr, gi)
    ci = hr.shape[2]
    h_re, h_im = (h.reshape(2 * m1, m2, b, ci).permute(2, 3, 0, 1)
                  for h in (hr, hi))
    dx = _inverse_plain(h_re, h_im, dy.shape[2:], modes).to(dy.dtype)
    return (dx, gr, gi) if film is None else (dx, gr, gi, dfilm)


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
    ``spectral_dw2d`` for the weight gradient. ``x`` is f32 or bf16; the
    output and dx have its type, the saved spectra and the weight gradients
    are f32. The weights are packed here on every call, so they stay in
    the graph; the forward keeps that pack (not the weights) for the
    backward's adjoint mix. With ``film`` ([b, co, 2*m1, m2], contiguous
    f32) the backward reads G scaled by the FiLM factor; where film requires
    a gradient, the forward also keeps the pre-FiLM spectrum, and the
    input-gradient launch returns the FiLM gradient too."""

    @staticmethod
    def forward(ctx, x, weights1, weights2, modes, film=None, film_mode=1):
        # a shape the backward takes in no variant is refused before the
        # forward runs
        b, ci, n1, n2 = x.shape
        _check_kernel_fits(b, weights1.shape[2], n1, n2, *modes,
                           "spectral_dft2d_bwd",
                           bf16=x.dtype == torch.bfloat16, c_out=ci)
        w_packed = pack_weights_2d((weights1, weights2))
        keep_y = film is not None and film.requires_grad
        out, xr, xi, *u = spectral_dft2d_fwd_spectrum(
            x, w_packed, modes, film, film_mode, keep_y=keep_y)
        ctx.save_for_backward(xr, xi, w_packed,
                              *([] if film is None else [film, *u]))
        ctx.modes, ctx.grid = modes, tuple(x.shape[2:])
        ctx.film_mode = film_mode
        return out

    @staticmethod
    def backward(ctx, dy):
        xr, xi, w_packed, *film_u = ctx.saved_tensors
        (m1, m2), (n1, n2) = ctx.modes, ctx.grid
        scale = mode_scale(n1, n2, m1, m2, dy.device)
        film_args = ((film_u[0], ctx.film_mode, tuple(film_u[1:]) or None,
                      scale) if film_u else ())
        dx, gr, gi, *dfilm = spectral_dft2d_bwd(dy.contiguous(), w_packed,
                                                ctx.modes, *film_args)
        dw1 = dw2 = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw1, dw2 = spectral_dw2d(xr, xi, gr, gi, scale, m1)
        needs = ctx.needs_input_grad
        return ((dx if needs[0] else None), dw1, dw2, None,
                (dfilm[0] if dfilm else None), None)


def spectral_conv_nd(x, weights, modes, film=None, film_mode=1,
                     num_spatial_dims=None, w_packed=None):
    """Apply a mode-truncated spectral conv to ``x`` [b, ci, *sp].

    Without gradients it calls the custom op ``nps_torch::spectral_dft2d_fwd``
    (:mod:`nps_tpu_torch.ops.library`) on either device, on the pack
    ``w_packed`` (:func:`pack_weights_2d` of ``weights``; packed here when
    the caller has none), so a caller can pack once instead of per call.
    Where a gradient is wanted the CUDA path takes :class:`SpectralConv2dFn`
    and the CPU path plain autograd; both ignore ``w_packed``. ``x`` is f32 or
    bf16, and the output has its type. A 1D call (``weights`` is
    [weights1]) is :func:`spectral_conv_1d` and a 3D one (``weights1..4``)
    :func:`spectral_conv_3d`, on either device, with or without gradients;
    both return f32.
    """
    nd = num_spatial_dims or (x.ndim - 2)
    modes = tuple(int(m) for m in modes)
    check_modes(modes, x.shape[2:2 + nd])
    if nd == 1:
        return spectral_conv_1d(x, weights[0], modes[0], film, film_mode)
    if nd == 3:
        return spectral_conv_3d(x, weights, modes, film)
    if nd != 2:
        raise NotImplementedError(f"no {nd}D spectral conv (1D, 2D, 3D)")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, *weights, film)):
        if x.device.type == "cpu":
            return spectral_conv_2d_plain(x, weights, modes, film, film_mode)
        if film is not None:
            film = film[:, :, :2 * modes[0], :modes[1]].float().contiguous()
        return SpectralConv2dFn.apply(x, weights[0], weights[1], modes, film,
                                      film_mode)
    if w_packed is None:
        w_packed = pack_weights_2d(weights)
    return torch.ops.nps_torch.spectral_dft2d_fwd(x, w_packed, *modes, film,
                                                  film_mode)


# ---- the row split of spatial parallelism ----------------------------------
# A rank holds rows [r0, r0 + nl) of an n1-row plane. The transform is linear
# in the rows, so it splits at the row contraction (nps_tpu/parallel/
# spatial.py: a contraction of the local rows, then a sum over the x group):
# stage A, the partial spectrum of the local rows; the sum; stage B, the mix
# and the inverse to the local rows. Each stage is one C entry of
# csrc/spectral_dft2d.cu over the kernels above, at the window's tables; the
# backward is stage A on dy (a partial G), the adjoint mix (a partial H), the
# weight gradient from the whole X and that partial G (so the optimizer's sum
# over the x group counts it once), the sum of H, and the inverse.


def _split_tc(x, variant, modes, n1, r0, which):
    """The tensor-core tables of the window (``which``: 0 the forward's ty,
    te; 1 the inverse's ta, tb) where the large-plane stage takes them for
    ``x`` (an input or an output), else two nulls."""
    nl, n2 = x.shape[2:]
    if variant != "large" or large_stages(x.dtype, n2, x.data_ptr()) == "fma":
        return (0, 0)
    t = tc_tables(n1, n2, *modes, x.device, rows=(r0, nl))
    return (t[0].data_ptr(), t[1].data_ptr()) if which == 0 else (
        t[2].data_ptr(), t[3].data_ptr())


def spectral_split_dft(x, modes, n1, r0, variant):
    """Stage A on CUDA: x [b, c, nl, n2] (rows [r0, r0 + nl) of an n1-row
    plane, f32 or bf16) -> its partial spectrum, f32 [2, 2*m1*m2, b, c]
    (real, imaginary). ``variant`` is :func:`_check_kernel_fits`'s at the
    local shape."""
    (m1, m2), (b, c, nl, n2) = modes, x.shape
    k = 2 * m1
    tables = dft_tables_rows(n1, n2, m1, m2, r0, nl, x.device)
    out = torch.empty((2, k * m2, b, c), dtype=torch.float32,
                      device=x.device)
    pr, pi = ((None, None) if variant == "resident"
              else _row_tile_partials(nl, k * m2, b, c, x.device))
    rc = kernels.library().spectral_split_dft(
        x.data_ptr(), *(t.data_ptr() for t in tables[:4]),
        *_split_tc(x, variant, modes, n1, r0, 0), _ptr(pr), _ptr(pi),
        out[0].data_ptr(), out[1].data_ptr(), b, c, nl, n2, m1, m2,
        int(x.dtype == torch.bfloat16), int(variant == "resident"),
        kernels.stream_ptr(x.device))
    kernels.check(rc, "spectral_split_dft")
    kernels.launches["spectral_split_dft"] += 1
    return out


def spectral_split_mix(xr, xi, w_packed, modes, film=None, film_mode=1,
                       u=None, scale=None, adjoint=False, out=None):
    """The mix of the split on CUDA. Forward: the summed spectrum X [modes,
    b, ci] and the pack [modes, 2, ci, co] -> Y [modes, b, co] with FiLM
    (``u`` = (ur, ui) [modes, b, co] receive the pre-FiLM Y where given).
    ``adjoint``: a partial G [modes, b, co] of dy (scaled in place by the
    FiLM factor; with ``u`` and ``scale`` the FiLM gradient is returned too)
    and the forward's pack -> the partial H [modes, b, ci]. Returns (yr, yi,
    dfilm); ``out`` [2, modes, b, c] takes Y or H where given."""
    b, c_in = xr.shape[1:]
    c_out = w_packed.shape[2] if adjoint else w_packed.shape[3]
    if out is None:
        out = torch.empty((2, xr.shape[0], b, c_out), dtype=torch.float32,
                          device=xr.device)
    dfilm = (torch.empty_like(film) if adjoint and film is not None
             and u is not None else None)
    ur, ui = u if u is not None else (None, None)
    rc = kernels.library().spectral_split_mix(
        xr.data_ptr(), xi.data_ptr(), w_packed.data_ptr(), _ptr(film),
        int(film_mode), _ptr(ur), _ptr(ui), _ptr(scale), _ptr(dfilm),
        out[0].data_ptr(), out[1].data_ptr(), b, c_in, c_out, *modes,
        int(adjoint), kernels.stream_ptr(xr.device))
    kernels.check(rc, "spectral_split_mix")
    kernels.launches["spectral_split_mix"] += 1
    return out[0], out[1], dfilm


def spectral_split_inv(yr, yi, modes, n1, r0, nl, n2, dtype, variant):
    """Stage B's inverse on CUDA: Y [modes, b, c] -> rows [r0, r0 + nl) of
    the n1-row plane's inverse, [b, c, nl, n2] in ``dtype``, scaled by
    1 / (n1 n2)."""
    (m1, m2), (b, c) = modes, yr.shape[1:]
    out = torch.empty((b, c, nl, n2), dtype=dtype, device=yr.device)
    tables = dft_tables_rows(n1, n2, m1, m2, r0, nl, yr.device)
    rc = kernels.library().spectral_split_inv(
        yr.data_ptr(), yi.data_ptr(), *(t.data_ptr() for t in tables[4:]),
        *_split_tc(out, variant, modes, n1, r0, 1), out.data_ptr(), b, c,
        nl, n2, m1, m2, 1.0 / (n1 * n2), int(dtype == torch.bfloat16),
        int(variant == "resident"), kernels.stream_ptr(yr.device))
    kernels.check(rc, "spectral_split_inv")
    kernels.launches["spectral_split_inv"] += 1
    return out


def _split_check(x, w_packed, modes, n1):
    """(forward variant, backward variant) of a split call at the local
    shape; raises on a shape neither takes, before anything runs."""
    _check_launch(x, w_packed, modes, "spectral_split_dft", 2,
                  (torch.float32, torch.bfloat16))
    b, ci, nl, n2 = x.shape
    co, bf16 = w_packed.shape[3], x.dtype == torch.bfloat16
    check_modes(modes, (n1, n2))
    return (_check_kernel_fits(b, ci, nl, n2, *modes, bf16=bf16, c_out=co),
            _check_kernel_fits(b, co, nl, n2, *modes, "spectral_dft2d_bwd",
                               bf16=bf16, c_out=ci))


def _split_forward(x, w_packed, modes, film, film_mode, axis, keep_y):
    """The split forward on CUDA: (out, X (summed), u or None, the
    backward's variant)."""
    from nps_tpu_torch.parallel.spatial import sum_

    n1 = axis.rows
    r0 = axis.part(n1)[0]
    variant, variant_bwd = _split_check(x, w_packed, modes, n1)
    xs = sum_(spectral_split_dft(x, modes, n1, r0, variant), axis)
    u = (tuple(torch.empty((2, xs.shape[1], x.shape[0], w_packed.shape[3]),
                           dtype=torch.float32, device=x.device))
         if keep_y else None)
    yr, yi, _ = spectral_split_mix(xs[0], xs[1], w_packed, modes, film,
                                   film_mode, u=u)
    out = spectral_split_inv(yr, yi, modes, n1, r0, x.shape[2], x.shape[3],
                             x.dtype, variant)
    return out, xs, u, variant_bwd


class SpectralConv2dSplitFn(torch.autograd.Function):
    """:class:`SpectralConv2dFn` on a row-split plane (``axis``: the x group,
    its ``rows`` the plane's n1): stage A, a sum over the x group, stage B;
    the backward is stage A on dy, the adjoint mix, the weight gradient from
    the summed X and this rank's partial G, a sum of H over the x group,
    and the inverse to the local rows."""

    @staticmethod
    def forward(ctx, x, weights1, weights2, modes, film, film_mode, axis):
        w_packed = pack_weights_2d((weights1, weights2))
        keep_y = film is not None and film.requires_grad
        out, xs, u, ctx.variant = _split_forward(x, w_packed, modes, film,
                                                 film_mode, axis, keep_y)
        ctx.save_for_backward(xs, w_packed,
                              *([] if film is None else [film, *(u or ())]))
        ctx.modes, ctx.axis, ctx.film_mode = modes, axis, film_mode
        return out

    @staticmethod
    def backward(ctx, dy):
        from nps_tpu_torch.parallel.spatial import sum_

        xs, w_packed, *film_u = ctx.saved_tensors
        axis, modes = ctx.axis, ctx.modes
        (m1, m2), (b, _, nl, n2) = modes, dy.shape
        n1 = axis.rows
        r0 = axis.part(n1)[0]
        dy, variant = dy.contiguous(), ctx.variant
        scale = mode_scale(n1, n2, m1, m2, dy.device)
        gr, gi = spectral_split_dft(dy, modes, n1, r0, variant)
        film = film_u[0] if film_u else None
        u = tuple(film_u[1:]) or None
        hs = torch.empty((2, gr.shape[0], b, w_packed.shape[2]),
                         dtype=torch.float32, device=dy.device)
        _, _, dfilm = spectral_split_mix(gr, gi, w_packed, modes, film,
                                         ctx.film_mode, u=u, scale=scale,
                                         adjoint=True, out=hs)
        dw1 = dw2 = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw1, dw2 = spectral_dw2d(xs[0], xs[1], gr, gi, scale, m1)
        dx = None
        if ctx.needs_input_grad[0]:
            hs = sum_(hs, axis)
            dx = spectral_split_inv(hs[0], hs[1], modes, n1, r0, nl, n2,
                                    dy.dtype, variant)
        return dx, dw1, dw2, None, dfilm, None, None


def spectral_conv_2d_split(x, weights, modes, film=None, film_mode=1,
                           axis=None, w_packed=None):
    """The 2D spectral conv of a row-split plane ``x`` [b, ci, nl, n2]
    (``axis``: the x group, its ``rows`` the plane's n1). On the CPU the
    plain stages around :func:`~nps_tpu_torch.parallel.spatial.spatial_sum`
    (autograd gives the backward); on CUDA :class:`SpectralConv2dSplitFn`
    where a gradient is wanted, else its forward stages on ``w_packed`` (or
    the weights packed here)."""
    from nps_tpu_torch.parallel.spatial import spatial_sum

    n1 = axis.rows
    r0 = axis.part(n1)[0]
    check_modes(modes, (n1, x.shape[3]))
    if film is not None:
        film = film[:, :, :2 * modes[0], :modes[1]].float().contiguous()
    if x.device.type == "cpu":
        xs = spatial_sum(torch.stack(_spectrum_plain(x, modes, (n1, r0))),
                         axis)
        y_re, y_im = _mix_plain(xs[0], xs[1], weights, modes, film,
                                film_mode)
        return _inverse_plain(y_re, y_im, x.shape[2:], modes,
                              (n1, r0)).to(x.dtype)
    x = x.contiguous()
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, *weights, film)):
        return SpectralConv2dSplitFn.apply(x, weights[0], weights[1], modes,
                                           film, film_mode, axis)
    if w_packed is None:
        w_packed = pack_weights_2d(weights)
    return _split_forward(x, w_packed, modes, film, film_mode, axis,
                          False)[0]
