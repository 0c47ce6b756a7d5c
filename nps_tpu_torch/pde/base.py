"""PDE metadata objects (counterpart of ``nps_tpu/pde/base.py``).

Plain holders of the time discretisation (tmin/tmax/nt -> dt), domain
extent, grid resolution and spacings, the coordinate grid ``x`` (a numpy
array, channels-last ``[*sp, nd]``) and the conditioning-signal sizes.
Extra kwargs become attributes.
"""

import numpy as np


class PDE:
    """Generic PDE metadata template."""

    def __init__(self, tmin, tmax, nt, name, n_cond_static=0, n_cond_dynamic=0,
                 n_cond_spatial=0, **kwargs):
        self.tmin = float(tmin)
        self.tmax = float(tmax)
        self.nt = int(nt)
        self.name = name
        self.n_cond_static = int(n_cond_static)
        self.n_cond_dynamic = int(n_cond_dynamic)
        self.n_cond_spatial = int(n_cond_spatial)
        for k, v in kwargs.items():
            setattr(self, k, v)

    def __repr__(self):
        return self.name


class PDE1D(PDE):
    def __init__(self, tmin, tmax, nt, L, nx, x, name, n_cond_static=0,
                 n_cond_dynamic=0, **kwargs):
        super().__init__(tmin, tmax, nt, name, n_cond_static, n_cond_dynamic,
                         **kwargs)
        self.dt = (self.tmax - self.tmin) / (self.nt - 1)
        self.L = float(L)
        self.nx = int(nx)
        self.dx = self.L / (self.nx - 1)
        self.dxs = [self.dx]
        if x is None:
            x = np.linspace(0.0, self.L, self.nx, dtype=np.float32)
        self.x = np.asarray(x)

    @property
    def num_spatial_dims(self):
        return 1

    @property
    def spatial_shape(self):
        return (self.nx,)


class PDE2D(PDE):
    def __init__(self, tmin, tmax, nt, L1, L2, nx1, nx2, x, name,
                 n_cond_static=0, n_cond_dynamic=0, n_cond_spatial=0,
                 **kwargs):
        super().__init__(tmin, tmax, nt, name, n_cond_static, n_cond_dynamic,
                         n_cond_spatial, **kwargs)
        self.L1 = float(L1)
        self.L2 = float(L2)
        self.L = [self.L1, self.L2]
        self.nx1 = int(nx1)
        self.nx2 = int(nx2)

        # NOTE: tmax/(nt-1), not (tmax-tmin)/(nt-1): the reference's quirk,
        # kept because the decoder's per-step delta scales by it
        self.dt = self.tmax / (self.nt - 1)
        self.dx1 = self.L1 / (self.nx1 - 1)
        self.dx2 = self.L2 / (self.nx2 - 1)
        self.dxs = [self.dx1, self.dx2]

        if x is None:
            g1 = np.linspace(0.0, self.L1, self.nx1, dtype=np.float32)
            g2 = np.linspace(0.0, self.L2, self.nx2, dtype=np.float32)
            x = np.stack(np.meshgrid(g1, g2, indexing="ij"), axis=-1)
        self.x = np.asarray(x)

    @property
    def num_spatial_dims(self):
        return 2

    @property
    def spatial_shape(self):
        return (self.nx1, self.nx2)


class PDE3D(PDE):
    """3D metadata with PDE2D's derived quantities (its ``dt`` quirk too)
    and the grid ``x`` [nx1, nx2, nx3, 3]."""

    def __init__(self, tmin, tmax, nt, L1, L2, L3, nx1, nx2, nx3, x, name,
                 n_cond_static=0, n_cond_dynamic=0, n_cond_spatial=0,
                 **kwargs):
        super().__init__(tmin, tmax, nt, name, n_cond_static, n_cond_dynamic,
                         n_cond_spatial, **kwargs)
        self.L1, self.L2, self.L3 = float(L1), float(L2), float(L3)
        self.L = [self.L1, self.L2, self.L3]
        self.nx1, self.nx2, self.nx3 = int(nx1), int(nx2), int(nx3)

        # tmax/(nt-1), as PDE2D
        self.dt = self.tmax / (self.nt - 1)
        self.dx1 = self.L1 / (self.nx1 - 1)
        self.dx2 = self.L2 / (self.nx2 - 1)
        self.dx3 = self.L3 / (self.nx3 - 1)
        self.dxs = [self.dx1, self.dx2, self.dx3]

        if x is None:
            grids = [np.linspace(0.0, L, n, dtype=np.float32)
                     for L, n in zip(self.L, (self.nx1, self.nx2, self.nx3))]
            x = np.stack(np.meshgrid(*grids, indexing="ij"), axis=-1)
        self.x = np.asarray(x)

    @property
    def num_spatial_dims(self):
        return 3

    @property
    def spatial_shape(self):
        return (self.nx1, self.nx2, self.nx3)
