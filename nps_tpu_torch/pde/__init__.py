from nps_tpu_torch.pde.base import PDE, PDE1D, PDE2D, PDE3D  # noqa: F401
