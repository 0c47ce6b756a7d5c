"""Synthetic twophase-shaped dataset generator (the port's own copy of
``nps_tpu/data/synthetic.py``; the same seed writes the same bytes):
:func:`generate` for the twophase contract below, :func:`generate_var_t`
for variable-length 1D simulations in ragged stores.

The real twophase dataset is an external download (reference ``README.md:16``);
tests and benchmarks need data with the same on-disk contract:

    <dir>/snapshots.npy               [n_sims, C, nt, nx1, nx2] float32
    <dir>/snapshots.yaml              x1, x2, tmin, tmax, dt
    <dir>/conditioning.npy            [n_sims, n_static]
    <dir>/spatial_conditioning.npy    [n_sims, n_spatial, nx1, nx2]
                                      (channel 0 = obstacle mask)
    <dir>/split.yaml                  train/valid/test index lists

The generated fields are advecting, diffusing saturation blobs with an
impermeable obstacle block — cheap to generate, physically flavored enough
that losses/metrics behave like the real workload.
"""

import argparse
import os

import numpy as np

from nps_tpu_torch.utils.io import save_yaml


def generate(out_dir, n_sims=16, n_channels=7, nt=101, nx1=96, nx2=64,
             n_static=2, n_spatial=2, tmax=10.0, seed=0,
             split=(0.8, 0.1, 0.1)):
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)

    x1 = np.linspace(0.0, 1.0, nx1, dtype=np.float32)
    x2 = np.linspace(0.0, 2 / 3, nx2, dtype=np.float32)
    X1, X2 = np.meshgrid(x1, x2, indexing="ij")

    snap_path = os.path.join(out_dir, "snapshots.npy")
    snaps = np.lib.format.open_memmap(
        snap_path, mode="w+", dtype=np.float32,
        shape=(n_sims, n_channels, nt, nx1, nx2))
    cond = np.zeros((n_sims, n_static), np.float32)
    sp_cond = np.zeros((n_sims, n_spatial, nx1, nx2), np.float32)

    t_grid = np.linspace(0.0, 1.0, nt, dtype=np.float32)[:, None, None]
    for s in range(n_sims):
        vel = rng.uniform(0.2, 1.0, size=2).astype(np.float32)
        widths = rng.uniform(0.05, 0.15, size=3).astype(np.float32)
        centers = rng.uniform(0.2, 0.8, size=(3, 2)).astype(np.float32)
        cond[s] = [vel[0], widths[0]]

        # obstacle block (channel 0 of spatial conditioning)
        ox, oy = rng.integers(nx1 // 4, nx1 // 2), rng.integers(nx2 // 4, nx2 // 2)
        w = rng.integers(2, max(nx1 // 6, 3))
        h = rng.integers(2, max(nx2 // 6, 3))
        mask = np.zeros((nx1, nx2), np.float32)
        mask[ox:ox + w, oy:oy + h] = 1.0
        sp_cond[s, 0] = mask
        if n_spatial > 1:
            sp_cond[s, 1] = rng.random((nx1, nx2), dtype=np.float32)

        # advecting gaussian blobs, periodic, diffusing over time
        for c in range(n_channels):
            field = np.zeros((nt, nx1, nx2), np.float32)
            for k in range(3):
                cx = centers[k, 0] + (0.3 + 0.1 * c) * vel[0] * t_grid[:, 0, 0]
                cy = centers[k, 1] * 2 / 3 + 0.2 * vel[1] * t_grid[:, 0, 0]
                sig = widths[k % 3] * (1.0 + 0.5 * t_grid[:, 0, 0])
                d1 = np.minimum(np.abs(X1[None] - cx[:, None, None]),
                                1.0 - np.abs(X1[None] - cx[:, None, None]))
                d2 = np.minimum(np.abs(X2[None] - cy[:, None, None]),
                                2 / 3 - np.abs(X2[None] - cy[:, None, None]))
                field += np.exp(-(d1 ** 2 + d2 ** 2) /
                                (2 * sig[:, None, None] ** 2)).astype(np.float32)
            field = field / field.max() * 0.9
            field = field * (1.0 - mask)[None]
            snaps[s, c] = field
    snaps.flush()
    del snaps

    save_yaml(os.path.join(out_dir, "snapshots.yaml"), dict(
        x1=[float(v) for v in x1], x2=[float(v) for v in x2],
        tmin=0.0, tmax=float(tmax), dt=float(tmax / (nt - 1))))
    np.save(os.path.join(out_dir, "conditioning.npy"), cond)
    np.save(os.path.join(out_dir, "spatial_conditioning.npy"), sp_cond)

    idx = list(range(n_sims))
    n_val = max(1, int(split[1] * n_sims))
    n_test = max(1, int(split[2] * n_sims))
    save_yaml(os.path.join(out_dir, "split.yaml"), dict(
        train=idx[: n_sims - n_val - n_test],
        valid=idx[n_sims - n_val - n_test: n_sims - n_test],
        test=idx[n_sims - n_test:]))
    return out_dir


def generate_var_t(out_dir, n_sims=12, n_channels=2, nx=32, t_min=40,
                   t_max=100, tmax_time=10.0, seed=0,
                   split=(0.7, 0.15, 0.15)):
    """Variable-length 1D dataset (D.sim1d_var_t contract): ragged snapshots
    of shape [c, t_i, nx] with per-simulation t_i."""
    from nps_tpu_torch.data.ragged import RaggedMemmap

    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)

    x = np.linspace(0.0, 1.0, nx, dtype=np.float32)
    sims, conds = [], []
    for s in range(n_sims):
        t_i = int(rng.integers(t_min, t_max + 1))
        vel = rng.uniform(0.5, 2.0)
        width = rng.uniform(0.05, 0.2)
        conds.append([vel, width])
        t_grid = np.linspace(0, 1, t_i, dtype=np.float32)[:, None]
        sim = np.zeros((n_channels, t_i, nx), np.float32)
        for c in range(n_channels):
            center = (0.3 + 0.1 * c + vel * t_grid) % 1.0
            d = np.minimum(np.abs(x[None] - center), 1 - np.abs(x[None] - center))
            sim[c] = np.exp(-d ** 2 / (2 * width ** 2))
        sims.append(sim)
    RaggedMemmap.save(os.path.join(out_dir, "snapshots"), sims)
    # one storage format per dataset (as upstream): conditioning rides the
    # ragged container too (its elements just happen to be fixed-size)
    RaggedMemmap.save(os.path.join(out_dir, "conditioning"),
                      [np.asarray(c, np.float32) for c in conds])
    save_yaml(os.path.join(out_dir, "snapshots.yaml"), dict(
        x=[float(v) for v in x], tmin=0.0, tmax=float(tmax_time),
        dt=float(tmax_time / (t_max - 1))))
    idx = list(range(n_sims))
    n_val = max(1, int(split[1] * n_sims))
    n_test = max(1, int(split[2] * n_sims))
    save_yaml(os.path.join(out_dir, "split.yaml"), dict(
        train=idx[: n_sims - n_val - n_test],
        valid=idx[n_sims - n_val - n_test: n_sims - n_test],
        test=idx[n_sims - n_test:]))
    return out_dir


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--n-sims", type=int, default=16)
    p.add_argument("--n-channels", type=int, default=7)
    p.add_argument("--nt", type=int, default=101)
    p.add_argument("--nx1", type=int, default=96)
    p.add_argument("--nx2", type=int, default=64)
    p.add_argument("--n-static", type=int, default=2)
    p.add_argument("--n-spatial", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args()
    generate(a.out, n_sims=a.n_sims, n_channels=a.n_channels, nt=a.nt,
             nx1=a.nx1, nx2=a.nx2, n_static=a.n_static,
             n_spatial=a.n_spatial, seed=a.seed)
    print(f"Wrote synthetic twophase dataset to {a.out}")


if __name__ == "__main__":
    main()
