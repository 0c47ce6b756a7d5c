"""2D snapshot dataset (twophase flow): split wiring and PDE metadata
(counterpart of ``nps_tpu/data/pde2d.py``): a MemMapDataset
with an optional channel filter (``c_filter``, e.g. ``[6]`` keeps only the
saturation channel), three ``Subset`` views selected either by a
``split.yaml`` index file or by a tail-fraction fallback, and a ``PDE2D``
metadata object derived from the stored grid/time axis and the conditioning
shapes of element 0.

The split semantics are contract: given the same sidecar yaml (or the same
fractions) the train/valid/test element indices must match the reference
exactly, so transplanted-weight evaluations see identical data.
"""

import os

import numpy as np

from nps_tpu_torch.common.interfaces import D
from nps_tpu_torch.data import transforms
from nps_tpu_torch.data.base import DatasetInterface, Subset
from nps_tpu_torch.data.memmap_dataset import MemMapDataset
from nps_tpu_torch.pde import PDE2D
from nps_tpu_torch.utils.io import load_yaml


def _split_indices(data_path, split_file, n_elements, split_val, split_test):
    """Resolve (train, valid, test) element indices.

    With a yaml sidecar the stored index lists are used verbatim
    (``src/data/PDE2D.py:49-56``). Without one, the tail of the element
    range is carved into val/test blocks of ``int(frac * n)`` elements each
    — val before test, train everything up front — reproducing the
    reference's fallback slicing (``:57-67``) including its edge behavior.
    """
    if split_file is not None:
        path = os.path.join(data_path, split_file if
                            split_file.lower().endswith(".yaml")
                            else split_file + ".yaml")
        stored = load_yaml(path)
        return tuple(np.array(stored[k]) for k in ("train", "valid", "test"))

    n_val = int(split_val * n_elements)
    n_test = int(split_test * n_elements)
    if n_val == 0 or n_test == 0:
        # the reference's negative-slice arithmetic (src/data/PDE2D.py:60-62)
        # degenerates at zero (every[:-0] is empty) — fail loudly instead
        raise ValueError(
            f"fractional split of {n_elements} elements gives val={n_val}, "
            f"test={n_test}; provide a split.yaml or a dataset large "
            f"enough that each split gets >= 1 element")
    every = np.arange(n_elements)
    pct_train = (1 - split_val - split_test) * 100
    print(f"Warning: No data split provided. Using {pct_train:.1f}%:"
          f"{split_val * 100:.1f}%:{split_test * 100:.1f}% train:valid:test")
    return (every[:-(n_val + n_test)],
            every[-(n_val + n_test):-n_test],
            every[-n_test:])


def _derive_pde(dataset, name, has_cond, has_t_cond, has_spatial_cond):
    """Build the PDE2D metadata from what the memmap sidecar recorded.

    Domain extents come from the stored grid corners, the frame count from
    ``tmax/dt``, and the conditioning channel counts from a probe of
    element 0 (``src/data/PDE2D.py:70-89``).
    """
    # reference formula is int(tmax/dt) + 1 (src/data/PDE2D.py:73); round
    # instead of truncating so float dust (10.0/0.1 -> 99.999...) cannot
    # drop a frame — identical on every exactly-divisible grid
    n_frames = int(round(dataset.tmax / dataset.dt)) + 1
    tmin, tmax = transforms.get_t_downsample(dataset.tmin, dataset.tmax,
                                             n_frames, ratio_nt=1)
    grid = dataset.x  # [nx1, nx2, 2]
    extent1 = grid[-1, 0, 0] - grid[0, 0, 0]
    extent2 = grid[0, -1, 1] - grid[0, 0, 1]

    probe = dataset[0]
    _, _, _, cond, t_cond, spatial_cond = probe
    return PDE2D(
        tmin=tmin, tmax=tmax, nt=n_frames,
        L1=extent1, L2=extent2,
        nx1=grid.shape[0], nx2=grid.shape[1], x=grid, name=name,
        n_cond_static=cond.shape[0] if has_cond else 0,
        n_cond_dynamic=t_cond.shape[0] if has_t_cond else 0,
        n_cond_spatial=spatial_cond.shape[0] if has_spatial_cond else 0)


class PDE2DDataset(DatasetInterface):
    data_interface = D.sim2d

    def __init__(self, base_path, experiment, data_format, data_file,
                 conditioning=None, t_conditioning=None,
                 spatial_conditioning=None, c_filter=None, split_file=None,
                 split_val=0.05, split_test=0.05, name="PDE2D",
                 preprocess=False, preprocess_path=None):
        self.experiment = experiment
        data_path = os.path.join(base_path, str(experiment))

        keep_channels = None if c_filter is None else np.asarray(c_filter)
        self.dataset = MemMapDataset(
            data_path, data_file, data_format=data_format,
            conditioning=conditioning, t_conditioning=t_conditioning,
            spatial_conditioning=spatial_conditioning,
            data_transform=(None if keep_channels is None
                            else lambda u: u[keep_channels]),
            grid_transform=None,
            preprocess=preprocess, preprocess_path=preprocess_path)

        splits = _split_indices(data_path, split_file, len(self.dataset),
                                split_val, split_test)
        self.train_dataset, self.valid_dataset, self.test_dataset = (
            Subset(self.dataset, idx) for idx in splits)

        self._pde = _derive_pde(self.dataset, name,
                                conditioning is not None,
                                t_conditioning is not None,
                                spatial_conditioning is not None)

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
