"""Dataset interface contract (counterpart of ``nps_tpu/data/base.py``).

A dataset exposes train/valid/test index-able splits (each yielding the
6-tuple ``(u_base, u, x, cond, t_cond, spatial_cond)`` of numpy arrays),
the governing PDE metadata, and its ``data_interface`` enum.
"""

from abc import ABCMeta, abstractmethod

from nps_tpu_torch.common.interfaces import D  # noqa: F401


class DatasetInterface(metaclass=ABCMeta):
    data_interface = None

    @property
    @abstractmethod
    def pde(self):
        ...

    @property
    @abstractmethod
    def train(self):
        ...

    @property
    @abstractmethod
    def valid(self):
        ...

    @property
    @abstractmethod
    def test(self):
        ...


class Subset:
    """Index-remapped view of a dataset."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(int(i) for i in indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]
