"""Data namespace (counterpart of ``nps_tpu/data``): the dataset classes
the training CLI resolves by name."""

from nps_tpu_torch.data.base import DatasetInterface  # noqa: F401
from nps_tpu_torch.data.memmap_dataset import MemMapDataset  # noqa: F401
from nps_tpu_torch.data.pde1d_var_t import PDE1DVarTDataset  # noqa: F401
from nps_tpu_torch.data.pde2d import PDE2DDataset  # noqa: F401
from nps_tpu_torch.data import transforms  # noqa: F401
