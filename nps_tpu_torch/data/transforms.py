"""Grid/time downsampling library, host-side numpy (counterpart of
``nps_tpu/data/transforms.py``, kept as the port's own copy): matrix-based
1D downsample / smoothing / interpolation matrices and periodic-smoothed
conv downsamplers, applied per element on the host.
"""

import math

import numpy as np


def get_1d_downsample_matrix(nx_in, nx_out, dtype=np.float32):
    assert nx_in > nx_out, "nx_out >= nx_in, this is not downsampling!"
    C = np.zeros((nx_in, nx_out), dtype=dtype)
    C[0, 0] = C[-1, -1] = 1
    grid_a = np.linspace(0, nx_in - 1, nx_in)
    grid_b = np.linspace(0, nx_in - 1, nx_out)
    ratio = (nx_in - 1) / (nx_out - 1)
    for i in range(1, nx_out - 1):
        j = math.floor(i * ratio)
        if grid_b[i] == grid_a[j]:
            C[j, i] = 1
        else:
            dif_a = abs(grid_a[j] - grid_b[i])
            dif_b = abs(grid_a[j + 1] - grid_b[i])
            total = dif_a + dif_b
            C[j, i] = (total - dif_a) / total
            C[j + 1, i] = (total - dif_b) / total
    return C


def get_1d_averaging_matrix(nx, n_average, boundary="periodic",
                            dtype=np.float32):
    assert n_average < nx, "Cannot smooth over more than the entire domain"
    assert n_average % 2 != 0, "Smoothing domain must be odd"
    C = np.zeros((nx, nx), dtype=dtype)
    for i in range(nx):
        s_i = i - n_average // 2
        e_i = i + n_average // 2 + 1
        if s_i < 0:
            if boundary == "periodic":
                idx = [j if j >= 0 else j + nx for j in range(s_i, e_i)]
            else:
                idx = [j for j in range(s_i, e_i) if j >= 0]
        elif e_i >= nx:
            if boundary == "periodic":
                idx = [j if j < nx else j - nx for j in range(s_i, e_i)]
            else:
                idx = [j for j in range(s_i, e_i) if j < nx]
        else:
            idx = list(range(s_i, e_i))
        for j in idx:
            C[j, i] = 1 / len(idx)
    return C


def downsample_1d_average_periodic_mm(ratio_nt, nx_in, nx_out, n_average,
                                      boundary="periodic", dtype=np.float32,
                                      has_c=False):
    do_smooth = n_average > 1
    do_down = nx_in > nx_out
    m = None
    if do_down:
        m = get_1d_downsample_matrix(nx_in, nx_out, dtype=dtype)
    if do_smooth:
        ms = get_1d_averaging_matrix(nx_in, n_average, boundary, dtype=dtype)
        m = ms @ m if m is not None else ms

    def inner(u):
        u = np.asarray(u)
        sliced = u[:, ::ratio_nt] if has_c else u[::ratio_nt]
        return sliced @ m if m is not None else sliced

    return inner


def downsample_1d_mm(nx_in, nx_out, dtype=np.float32):
    m = (get_1d_downsample_matrix(nx_in, nx_out, dtype=dtype)
         if nx_in > nx_out else None)

    def inner(x):
        return np.asarray(x) @ m if m is not None else np.asarray(x)

    return inner


def get_t_downsample(tmin, tmax, nt_in, nt_out=None, ratio_nt=None):
    tdelta = tmax - tmin
    range_old = [tmin + (x / (nt_in - 1) * tdelta) for x in range(nt_in)]
    if nt_out is None and ratio_nt is None:
        raise ValueError("Either nt_out or ratio_nt must be specified")
    if ratio_nt is None:
        ratio_nt = nt_in / nt_out
    if not isinstance(ratio_nt, int):
        assert float(ratio_nt).is_integer()
        ratio_nt = int(ratio_nt)
    range_new = range_old[::ratio_nt]
    return range_new[0], range_new[-1]


def get_1d_interp_matrix(grid_in, grid_out, dtype=np.float32):
    """Interpolation matrix between sorted, possibly non-uniform 1D grids."""
    grid_in, grid_out = np.asarray(grid_in), np.asarray(grid_out)
    assert grid_in.ndim == grid_out.ndim == 1, "grid not 1d"
    assert np.all(grid_in[:-1] <= grid_in[1:]), "grid_in not sorted"
    assert np.all(grid_out[:-1] <= grid_out[1:]), "grid_out not sorted"
    nx_in, nx_out = grid_in.shape[0], grid_out.shape[0]
    C = np.zeros((nx_in, nx_out), dtype=dtype)
    for i in range(nx_out):
        if grid_out[i] <= grid_in[0]:
            C[0, i] = 1
        elif grid_out[i] >= grid_in[-1]:
            C[-1, i] = 1
        else:
            j = np.searchsorted(grid_in, grid_out[i])
            if grid_in[j] == grid_out[i]:
                C[j, i] = 1
            else:
                dif_a = abs(grid_in[j] - grid_out[i])
                dif_b = abs(grid_in[j - 1] - grid_out[i])
                total = dif_a + dif_b
                C[j, i] = (total - dif_a) / total
                C[j - 1, i] = (total - dif_b) / total
    return C


def get_1d_interp_matrix_to_even(grid_in, nx_out=None, dtype=np.float32):
    grid_in = np.asarray(grid_in)
    if nx_out is None:
        nx_out = grid_in.shape[0]
    grid_out = np.linspace(grid_in[0], grid_in[-1], nx_out)
    return get_1d_interp_matrix(grid_in, grid_out, dtype=dtype)


def downsample_2d_average_periodic(u, ratio_nt, ratio_nx):
    """Periodic 5x5 box-smoothed strided 2D downsampling, numpy."""
    u = np.asarray(u)[::ratio_nt]
    u = np.concatenate([u[:, -3:-1], u, u[:, 1:3]], axis=1)
    u = np.concatenate([u[:, :, -3:-1], u, u[:, :, 1:3]], axis=2)
    t, nx, ny = u.shape
    out_x = (nx - 5) // ratio_nx + 1
    out_y = (ny - 5) // ratio_nx + 1
    # sliding 5x5 mean with stride = windowed view
    sw = np.lib.stride_tricks.sliding_window_view(u, (5, 5), axis=(1, 2))
    return sw[:, ::ratio_nx, ::ratio_nx].mean(axis=(-1, -2))[:, :out_x, :out_y]
