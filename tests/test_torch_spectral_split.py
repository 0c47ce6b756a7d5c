"""The numerics of the large-plane spectral conv's tensor-core stages
(``dft_fwd_tc_kernel``, ``dft_inv_tc_kernel`` in
``nps_tpu_torch/csrc/spectral_dft2d.cu``), held on the CPU against
``nps_tpu.ops.spectral.spectral_conv_nd``.

(a) The hi + lo bf16 split of the f32 DFT tables rebuilds each table to
    within 2^-16 of its largest entry.
(b) An emulation, in this file, of what the two kernels compute, fragment
    by fragment: the tables as the port packs them for ``mma.sync``
    m16n8k16 (unpacked here by the PTX fragment layout), bf16 x, x (hi) +
    x (lo) with f32 sums, T split into hi + lo at the handoff to the x pass
    (three products), the row pass on Y split the same way, Z split at
    the handoff to the column pass (Z hi E hi + Z hi E lo + Z lo E hi),
    one bf16 rounding. Against JAX at precision="highest" on the same
    bf16-rounded x in f32: the bf16 output < 1e-2 (the bar of the card's
    plain-version check; its error is the one rounding, ~2^-9), the f32
    output before that rounding < 1e-4 and the spectrum X < 1e-5 (what
    the split terms are for). The input gradient through the same stages
    against ``jax.vjp`` likewise.
(c) The Python mirror of the kernels' stage choice (tensor cores or FMAs)
    by type, row length and alignment, and the new shared-memory limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nps_tpu.ops.spectral import spectral_conv_nd as jax_spectral
from nps_tpu_torch.ops import spectral as sp

LANE = np.arange(32)
G, T = LANE // 4, LANE % 4
A_SLOTS = ((0, 0), (8, 0), (0, 8), (8, 8))   # a0..a3: (row, col) offsets


@pytest.fixture(autouse=True)
def _few_threads():
    """The suite's workers share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _bf16(a):
    """Round to bf16 (torch's conversion: nearest, ties to even), as f32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _halves(w):
    """uint32 fragment words -> (low element, high element) as f32."""
    w = w.astype(np.uint32)
    return ((w << np.uint32(16)).view(np.float32),
            (w & np.uint32(0xFFFF0000)).view(np.float32))


def _words(e0, e1):
    return ((_bf16(e0).view(np.uint32) >> np.uint32(16))
            | (_bf16(e1).view(np.uint32) & np.uint32(0xFFFF0000)))


def _split2(v0, v1):
    """The kernels' split_bf16x2: (hi words, lo words)."""
    h0, h1 = _bf16(v0), _bf16(v1)
    return _words(h0, h1), _words(v0 - h0, v1 - h1)


def a_mat(r):
    """A fragments [..., 32, 4] -> the 16x16 matrices they hold."""
    out = np.zeros(r.shape[:-2] + (16, 16), np.float32)
    for q, (dr, dc) in enumerate(A_SLOTS):
        lo, hi = _halves(r[..., q])
        out[..., G + dr, 2 * T + dc] = lo
        out[..., G + dr, 2 * T + dc + 1] = hi
    return out


def b_mat(r):
    """B fragments [..., 32, 2] -> the 16x8 matrices they hold."""
    out = np.zeros(r.shape[:-2] + (16, 8), np.float32)
    for q, dk in enumerate((0, 8)):
        lo, hi = _halves(r[..., q])
        out[..., 2 * T + dk, G] = lo
        out[..., 2 * T + dk + 1, G] = hi
    return out


def c_frag(c):
    """16x8 f32 accumulators [..., 16, 8] -> each lane's c0..c3."""
    return np.stack([c[..., G, 2 * T], c[..., G, 2 * T + 1],
                     c[..., G + 8, 2 * T], c[..., G + 8, 2 * T + 1]], -1)


def _mm(spec, *ops):
    return np.einsum(spec, *ops, optimize=True).astype(np.float32)


def emulate_fwd_stage(x, n1, n2, m1, m2):
    """dft_fwd_tc_kernel (and sum_tiles_kernel) on planes x [P, n1, n2]
    (bf16 values): the spectrum (X_re, X_im), each [P, 2*m1, m2]."""
    ty, te = sp.tc_tables_np(n1, n2, m1, m2)[:2]
    p, k, mt = x.shape[0], 2 * m1, sp.tc_mt(m2)
    i_tiles, tiles, steps, nt = (mt + 1) // 2, -(-n1 // 256), ty.shape[0], \
        te.shape[1]
    xp = np.zeros((p, tiles * 256, steps * 16), np.float32)
    xp[:, :n1, :n2] = x
    # y pass: A = ty per (step, tile); B of warp w, n-tile j, step s:
    # B[k, n] = x[32 w + 8 j + n, 16 s + k] (what ldmatrix gives)
    ay = a_mat(ty)                                     # [s, MT, 16, 16]
    xb = xp.reshape(p, tiles, 8, 4, 8, steps, 16).transpose(
        0, 1, 2, 3, 5, 6, 4)                           # [p, t, w, j, s, k, n]
    acc = c_frag(_mm("simk,ptwjskn->ptwijmn", ay, xb))  # [p,t,w,MT,j,32,4]
    pad = np.zeros(acc.shape[:3] + (2 * i_tiles - mt,) + acc.shape[4:],
                   np.float32)
    acc = np.concatenate([acc, pad], 3)
    # T = hi + lo products, split into hi + lo as x-pass A fragments
    tf = np.zeros((p, tiles, i_tiles, 16, 2, 32, 4), np.uint32)
    for ii in range(i_tiles):
        for s in range(2):
            for q in range(4):
                c = acc[:, :, :, 2 * ii + (q & 1), 2 * s + (q >> 1)]
                hi, lo = _split2(c[..., 0] + c[..., 2], c[..., 1] + c[..., 3])
                tf[:, :, ii, s::2, 0, :, q] = hi
                tf[:, :, ii, s::2, 1, :, q] = lo
    a_hi, a_lo = a_mat(tf[:, :, :, :, 0]), a_mat(tf[:, :, :, :, 1])
    te = te.reshape(tiles, 16, nt, 32, 4)
    b_hi, b_lo = b_mat(te[..., :2]), b_mat(te[..., 2:])
    spec = "ptikab,tknbc->ptinac"
    pq = (_mm(spec, a_hi, b_hi) + _mm(spec, a_hi, b_lo)
          + _mm(spec, a_lo, b_hi))                     # [p,t,I,NT,16,8]
    pq = pq.transpose(0, 1, 2, 4, 3, 5).reshape(p, tiles, 16 * i_tiles,
                                                 8 * nt)
    pc, ps = pq[:, :, :m2], pq[:, :, m2:2 * m2]
    x_re = (pc[..., :k] - ps[..., k:2 * k]).transpose(0, 1, 3, 2)
    x_im = (-ps[..., :k] - pc[..., k:2 * k]).transpose(0, 1, 3, 2)
    out_re, out_im = np.zeros_like(x_re[:, 0]), np.zeros_like(x_im[:, 0])
    for t in range(tiles):                             # tile order
        out_re += x_re[:, t]
        out_im += x_im[:, t]
    return out_re, out_im


def emulate_inv_stage(y_re, y_im, n1, n2, m1, m2):
    """dft_inv_tc_kernel on the spectra Y [P, 2*m1, m2] (real, imaginary):
    the output [P, n1, n2] in f32, before its rounding to bf16."""
    ta, tb = sp.tc_tables_np(n1, n2, m1, m2)[2:]
    p, k, mt = y_re.shape[0], 2 * m1, sp.tc_mt(m2)
    ks1, ksz, rb = ta.shape[1], tb.shape[1], ta.shape[0]
    # row pass B: [[Yr, Yi], [-Yi, Yr]], split elementwise into hi + lo
    bf = np.zeros((p, 16 * ks1, 8 * mt), np.float32)
    bf[:, :k, :m2], bf[:, :k, m2:2 * m2] = y_re, y_im
    bf[:, k:2 * k, :m2], bf[:, k:2 * k, m2:2 * m2] = -y_im, y_re
    b_hi = _bf16(bf)
    b_lo = _bf16(bf - b_hi)
    b_hi, b_lo = (b.reshape(p, ks1, 16, mt, 8).transpose(0, 1, 3, 2, 4)
                  for b in (b_hi, b_lo))               # [p, s, t, 16, 8]
    a_hi, a_lo = a_mat(ta[:, :, 0]), a_mat(ta[:, :, 1])  # [rb, s, 16, 16]
    spec = "rsab,pstbc->prtac"
    z = c_frag(_mm(spec, a_hi, b_hi) + _mm(spec, a_hi, b_lo)
               + _mm(spec, a_lo, b_hi))                # [p, rb, MT, 32, 4]
    # Z as the column pass's A fragments: k-step s holds Z's n-tiles 2s
    # (a0, a1: rows g, g+8) and 2s + 1 (a2, a3), split into hi + lo
    z_hi = np.zeros((p, rb, ksz, 32, 4), np.uint32)
    z_lo = np.zeros_like(z_hi)
    for s in range(ksz):
        for q in range(4):
            t, h = 2 * s + (q >> 1), q & 1
            if t < mt:
                z_hi[..., s, :, q], z_lo[..., s, :, q] = _split2(
                    z[:, :, t, :, 2 * h], z[:, :, t, :, 2 * h + 1])
    e_hi, e_lo = b_mat(tb[..., :2]), b_mat(tb[..., 2:])  # [nt, s, 16, 8]
    spec = "prsab,nsbc->prnac"
    out = (_mm(spec, a_mat(z_hi), e_hi) + _mm(spec, a_mat(z_hi), e_lo)
           + _mm(spec, a_mat(z_lo), e_hi))             # [p, rb, nt, 16, 8]
    out = out.transpose(0, 1, 3, 2, 4).reshape(p, 16 * rb, n2)[:, :n1]
    return out * np.float32(1.0 / (n1 * n2))


def _mix(x_re, x_im, w_re, w_im):
    """Y_o = sum_i X_i W_io per mode: X [b, i, k, m], W [i, o, k, m]."""
    return (_mm("bikm,iokm->bokm", x_re, w_re)
            - _mm("bikm,iokm->bokm", x_im, w_im),
            _mm("bikm,iokm->bokm", x_re, w_im)
            + _mm("bikm,iokm->bokm", x_im, w_re))


def emulate_conv(x, ws, modes):
    """The large-plane call on the tensor-core stages: x [b, ci, n1, n2]
    (bf16 values) -> (out before rounding, its X spectrum)."""
    (m1, m2), (b, ci, n1, n2) = modes, x.shape
    w = np.concatenate(ws, axis=3)                     # [2, ci, co, 2m1, m2]
    x_re, x_im = emulate_fwd_stage(x.reshape(b * ci, n1, n2), n1, n2, m1, m2)
    spec = (x_re.reshape(b, ci, 2 * m1, m2), x_im.reshape(b, ci, 2 * m1, m2))
    y_re, y_im = _mix(*spec, w[0], w[1])
    co = w.shape[2]
    out = emulate_inv_stage(y_re.reshape(b * co, 2 * m1, m2),
                            y_im.reshape(b * co, 2 * m1, m2), n1, n2, m1, m2)
    return out.reshape(b, co, n1, n2), spec


def emulate_input_grad(dy, ws, modes):
    """spectral_dft2d_bwd_large on the tensor-core stages: the same two
    stages around the adjoint mix H_i = sum_o conj(W_io) G_o."""
    (m1, m2), (b, co, n1, n2) = modes, dy.shape
    w = np.concatenate(ws, axis=3).transpose(0, 2, 1, 3, 4)  # [2, co, ci..]
    g_re, g_im = emulate_fwd_stage(dy.reshape(b * co, n1, n2), n1, n2, m1,
                                   m2)
    h_re, h_im = _mix(g_re.reshape(b, co, 2 * m1, m2),
                      g_im.reshape(b, co, 2 * m1, m2), w[0], -w[1])
    ci = w.shape[2]
    dx = emulate_inv_stage(h_re.reshape(b * ci, 2 * m1, m2),
                           h_im.reshape(b * ci, 2 * m1, m2), n1, n2, m1, m2)
    return dx.reshape(b, ci, n1, n2)


def _rel(a, ref):
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _inputs(seed, b, ci, co, grid, modes):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((b, ci) + grid))
    ws = [(rng.random((2, ci, co) + modes) / (ci * co)).astype(np.float32)
          for _ in range(2)]
    return x, ws


def _jax_conv(x, ws, modes):
    """JAX's conv on x [b, c, n1, n2] (channels moved last and back)."""
    with jax.default_matmul_precision("highest"):
        y = jax_spectral(jnp.asarray(x.transpose(0, 2, 3, 1)),
                         [jnp.asarray(w) for w in ws], modes,
                         precision="highest")
    return np.asarray(y).transpose(0, 3, 1, 2)


def _jax_spectrum(x, modes):
    """JAX's truncated spectrum of x [b, c, n1, n2]: rfft2's retained
    low and high row blocks, [b, c, 2*m1, m2]."""
    m1, m2 = modes
    f = np.fft.rfft2(x.astype(np.float64))
    f = np.concatenate([f[:, :, :m1, :m2], f[:, :, -m1:, :m2]], axis=2)
    return f.real, f.imag


# (b, ci, co, grid, modes): a small plane, and one narrow 512^2 plane at
# the ns512 modes (two row tiles)
SHAPES = [(2, 5, 7, (64, 48), (6, 8)), (1, 2, 2, (512, 512), (20, 20))]


# ---- (a) the split tables ---------------------------------------------------
@pytest.mark.parametrize("n1,n2,m1,m2", [(512, 512, 20, 20), (64, 48, 6, 8),
                                         (1024, 1024, 32, 32),
                                         (300, 200, 20, 17)])
def test_split_tables_rebuild_the_f32_tables(n1, n2, m1, m2):
    """hi + lo of every f32 factor table within 2^-16 of its largest entry;
    hi and lo are bf16 values; the packed tables hold exactly those terms
    (unpacked by the PTX fragment layout)."""
    for t in sp.dft_tables(n1, n2, m1, m2, "cpu"):
        a = t.numpy()
        hi, lo = sp.split_bf16(a)
        assert np.array_equal(hi, _bf16(hi)) and np.array_equal(lo, _bf16(lo))
        assert np.abs(hi + lo - a).max() <= 2.0 ** -16 * np.abs(a).max()
    ty, te, ta, tb = sp.tc_tables_np(n1, n2, m1, m2)
    c2, s2 = (t.numpy() for t in sp.dft_tables(n1, n2, m1, m2, "cpu")[:2])
    ay = a_mat(ty)                                     # [s, MT, 16, 16]
    mt = sp.tc_mt(m2)
    rows = ay.transpose(1, 2, 0, 3).reshape(mt, 16, -1)[..., :n2]
    f = np.zeros((8 * mt, n2), np.float32)
    f[:m2], f[m2:2 * m2] = c2.T, s2.T
    hi, lo = sp.split_bf16(f)
    assert np.array_equal(rows[:, :8].reshape(8 * mt, n2), hi)
    assert np.array_equal(rows[:, 8:].reshape(8 * mt, n2), lo)


def test_tc_tables_built_once_per_key():
    """The device tables are cached beside dft_tables, one build per key."""
    first = sp.tc_tables(64, 48, 6, 8, "cpu")
    assert all(a is b for a, b in zip(first, sp.tc_tables(64, 48, 6, 8,
                                                          "cpu")))
    assert [tuple(t.shape) for t in first] == [
        (4, 3, 32, 4), (16, 3, 32, 4), (16, 2, 2, 32, 4), (6, 2, 32, 4)]
    assert all(t.dtype == torch.int32 for t in first)


# ---- (b) the emulated kernels against JAX -----------------------------------
@pytest.mark.parametrize("b,ci,co,grid,modes", SHAPES)
def test_emulated_tc_forward_matches_jax(b, ci, co, grid, modes):
    x, ws = _inputs(3, b, ci, co, grid, modes)
    out, (x_re, x_im) = emulate_conv(x, ws, modes)
    ref = _jax_conv(x, ws, modes)
    err_bf16 = _rel(_bf16(out), ref)
    err_f32 = _rel(out, ref)
    s_re, s_im = _jax_spectrum(x, modes)
    err_x = max(_rel(x_re, s_re), _rel(x_im, s_im))
    print(f"tc forward {grid}: bf16 {err_bf16:.3e}, f32 {err_f32:.3e}, "
          f"X {err_x:.3e}")
    assert err_bf16 < 1e-2
    assert err_f32 < 1e-4
    assert err_x < 1e-5


def test_emulated_tc_input_gradient_matches_jax_vjp():
    b, ci, co, grid, modes = SHAPES[0]
    x, ws = _inputs(4, b, ci, co, grid, modes)
    dy = _bf16(np.random.default_rng(5).standard_normal((b, co) + grid))
    dx = emulate_input_grad(dy, ws, modes)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda v: jax_spectral(
            v, [jnp.asarray(w) for w in ws], modes, precision="highest"),
            jnp.asarray(x.transpose(0, 2, 3, 1)))
        ref = np.asarray(vjp(jnp.asarray(dy.transpose(0, 2, 3, 1)))[0])
    ref = ref.transpose(0, 3, 1, 2)
    err_bf16, err_f32 = _rel(_bf16(dx), ref), _rel(dx, ref)
    print(f"tc input gradient: bf16 {err_bf16:.3e}, f32 {err_f32:.3e}")
    assert err_bf16 < 1e-2
    assert err_f32 < 1e-4


def test_emulated_tc_forward_matches_the_port_plain_version():
    """The same emulation against the port's own plain version (the card's
    yardstick), on the bf16 input, with its bf16 output."""
    b, ci, co, grid, modes = SHAPES[0]
    x, ws = _inputs(6, b, ci, co, grid, modes)
    out = _bf16(emulate_conv(x, ws, modes)[0])
    plain = sp.spectral_conv_2d_plain(
        torch.from_numpy(x).to(torch.bfloat16),
        [torch.from_numpy(w) for w in ws], modes).float().numpy()
    assert _rel(out, plain) < 1e-2


# ---- (c) the stage choice ---------------------------------------------------
@pytest.mark.parametrize("dtype,n2,ptrs,stages", [
    (torch.bfloat16, 512, (0, 1 << 20), "tensor"),   # the ns512 call
    (torch.bfloat16, 200, (16, 48), "tensor"),
    (torch.bfloat16, 64, (64, 128), "tensor"),       # a twophase plane
    (torch.bfloat16, 98, (0, 0), "fma"),             # rows not 8 points
    (torch.bfloat16, 36, (0, 0), "fma"),
    (torch.bfloat16, 512, (8, 0), "fma"),            # x off 16 bytes
    (torch.bfloat16, 512, (0, 2), "fma"),            # out off 16 bytes
    (torch.float32, 512, (0, 0), "fma"),             # f32 keeps the FMAs
])
def test_large_stages_by_type_row_and_alignment(dtype, n2, ptrs, stages):
    assert sp.large_stages(dtype, n2, *ptrs) == stages


def test_ns512_calls_take_the_tensor_core_stages():
    """The ns512 forward and input-gradient shapes are large-plane calls,
    and fresh bf16 tensors of them (16-byte aligned) take the tensor-core
    stages; f32 takes the FMA ones."""
    for c_in, c_out, name in ((132, 128, "spectral_dft2d_fwd"),
                              (128, 132, "spectral_dft2d_bwd")):
        assert sp._check_kernel_fits(8, c_in, 512, 512, 20, 20, name,
                                     bf16=True, c_out=c_out) == "large"
    x = torch.empty((1, 2, 512, 512), dtype=torch.bfloat16)
    out = torch.empty_like(x)
    assert sp.large_stages(x.dtype, 512, x.data_ptr(),
                           out.data_ptr()) == "tensor"
    assert sp.large_stages(torch.float32, 512, x.data_ptr(),
                           out.data_ptr()) == "fma"


def test_tensor_core_stages_shared_memory_limit():
    """Row modes whose x-pass scratch exceeds a CTA's shared memory raise
    for bf16 rows the tensor-core stages would take, not for f32."""
    with pytest.raises(ValueError, match="tensor-core stages need"):
        sp._check_kernel_fits(1, 4, 512, 512, 200, 32, bf16=True, c_out=4)
    assert sp._check_kernel_fits(1, 4, 512, 512, 200, 32, c_out=4) == "large"
    assert sp._check_kernel_fits(1, 4, 1024, 1024, 32, 32, bf16=True,
                                 c_out=4) == "large"
