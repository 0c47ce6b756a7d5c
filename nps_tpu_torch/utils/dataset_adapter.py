"""Adapt any index-able dataset into a DatasetInterface split (counterpart
of ``nps_tpu/utils/dataset_adapter.py``).

Wrap a raw dataset as the train / valid / test / all split of a
DatasetInterface, for ad-hoc evaluation runs.
"""

from nps_tpu_torch.common.interfaces import D
from nps_tpu_torch.data.base import DatasetInterface


class DatasetToInterface(DatasetInterface):
    def __init__(self, dataset, interface, set_as="test", pde=None):
        if set_as not in ("train", "valid", "test", "all"):
            raise ValueError(
                '"set_as" should be "train", "valid", "test" or "all"')
        if interface not in D:
            raise ValueError('"interface" should be defined in D')
        self.dataset = dataset
        self.set_as = set_as
        self.interface = interface
        self._pde = pde

    def __repr__(self):
        return (f"dataset_to_interface-{self.set_as}-{self.interface}-"
                f"{self.dataset}")

    @property
    def pde(self):
        return self._pde

    @property
    def data_interface(self):
        return self.interface

    def _maybe(self, names):
        return self.dataset if self.set_as in names else None

    @property
    def train(self):
        return self._maybe(("train", "all"))

    @property
    def valid(self):
        return self._maybe(("valid", "all"))

    @property
    def test(self):
        return self._maybe(("test", "all"))
