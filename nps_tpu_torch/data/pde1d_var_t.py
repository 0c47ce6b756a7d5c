"""Variable-length 1D simulation dataset (``D.sim1d_var_t``; counterpart of
``nps_tpu/data/pde1d_var_t.py``).

The reference carries the variable-time *contract* (enums, collate helpers,
trainer branches) but ships no dataset class for it
(``src/data/__init__.py`` exports only PDE2DDataset). This class completes
the contract: ragged-memmap storage (one simulation per element, shape
``[c, t_i, nx]`` with varying ``t_i``), split handling, and PDE1D metadata
derived from the longest simulation.
"""

import os

import numpy as np

from nps_tpu_torch.common.interfaces import D
from nps_tpu_torch.data.base import DatasetInterface, Subset
from nps_tpu_torch.data.memmap_dataset import MemMapDataset
from nps_tpu_torch.pde import PDE1D
from nps_tpu_torch.utils.io import load_yaml


class PDE1DVarTDataset(DatasetInterface):
    data_interface = D.sim1d_var_t

    def __init__(self, base_path, experiment, data_file="snapshots",
                 conditioning=None, t_conditioning=None, split_file=None,
                 split_val=0.1, split_test=0.1, name="PDE1DVarT",
                 c_filter=None):
        data_path = os.path.join(base_path, f"{experiment}")
        self.experiment = experiment

        data_transform = None
        if c_filter is not None:
            c_idx = np.array(c_filter)
            data_transform = lambda u: u[c_idx]  # noqa: E731

        self.dataset = MemMapDataset(
            data_path, data_file, data_format="raggedmemmap",
            conditioning=conditioning, t_conditioning=t_conditioning,
            data_transform=data_transform)

        n = len(self.dataset)
        if split_file is not None:
            if not split_file.lower().endswith(".yaml"):
                split_file += ".yaml"
            split = load_yaml(os.path.join(data_path, split_file))
            train_idx, valid_idx, test_idx = (split["train"], split["valid"],
                                              split["test"])
        else:
            idx = np.arange(n)
            n_val = max(1, int(split_val * n))
            n_test = max(1, int(split_test * n))
            train_idx = idx[:-(n_val + n_test)]
            valid_idx = idx[-(n_val + n_test):-n_test]
            test_idx = idx[-n_test:]

        self.train_dataset = Subset(self.dataset, train_idx)
        self.valid_dataset = Subset(self.dataset, valid_idx)
        self.test_dataset = Subset(self.dataset, test_idx)

        x = self.dataset.x
        nx = x.shape[0]
        L = float(x[-1] - x[0])
        nt_max = max(self.dataset[i][1].shape[1] for i in range(n))
        _, _, _, cond, t_cond, _ = self.dataset[0]
        self._pde = PDE1D(
            tmin=self.dataset.tmin, tmax=self.dataset.tmax, nt=nt_max, L=L,
            nx=nx, x=x, name=name,
            n_cond_static=cond.shape[0] if conditioning is not None else 0,
            n_cond_dynamic=t_cond.shape[0] if t_conditioning is not None else 0)

    @property
    def pde(self):
        return self._pde

    def __repr__(self):
        return f"{self.pde}_{self.experiment}"

    @property
    def train(self):
        return self.train_dataset

    @property
    def valid(self):
        return self.valid_dataset

    @property
    def test(self):
        return self.test_dataset
