"""Batch samplers for variable-time datasets (counterpart of
``nps_tpu/data/samplers.py``; its draws come from the same numpy generator,
so a seed gives the same batches and depths).

The reference's var-t configs reference an *external* sampler object
(``trainers/base.py:181-192`` reads ``config.sampler['object']`` and calls
``loader.batch_sampler.get_t_batch(batch_idx)``; no sampler class ships in
the repo). This module provides a first-class implementation with the same
interface contract:

- iterate -> lists of element indices per batch;
- ``get_t_batch(batch_idx)`` -> the pushforward unroll depth for that batch,
  drawn uniformly from the depths admissible given the batch's shortest
  simulation (a window of (depth + 2) * tw frames must fit).
"""

import numpy as np


class VariableTimeBatchSampler:
    def __init__(self, dataset, batch_size, time_window=25, max_unrolling=0,
                 with_replacement=True, seed=0, t_dim=1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.tw = time_window
        self.max_unrolling = max_unrolling
        self.with_replacement = with_replacement
        self._rng = np.random.default_rng(seed)
        self._lengths = np.array(
            [dataset[i][1].shape[t_dim] for i in range(len(dataset))])
        self._batches = []
        self._t_batch = {}

    @property
    def lengths(self):
        """Per-element time lengths (metadata, no element IO) — lets a
        multi-process loader compute GLOBAL crop/pad extents without
        materialising off-process elements."""
        return self._lengths

    def __len__(self):
        n = len(self.dataset)
        return max(1, n // self.batch_size) if self.with_replacement else \
            (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.dataset)
        self._t_batch = {}
        self._batches = []
        if self.with_replacement:
            for _ in range(len(self)):
                self._batches.append(list(self._rng.integers(0, n,
                                                             self.batch_size)))
        else:
            order = self._rng.permutation(n)
            for s in range(0, n, self.batch_size):
                self._batches.append([int(i) for i in order[s:s + self.batch_size]])
        for bi, idxs in enumerate(self._batches):
            t_min = int(self._lengths[idxs].min())
            t_min -= t_min % self.tw  # min-crop rounds down to a tw multiple
            admissible = max(0, t_min // self.tw - 2)
            depth = int(self._rng.integers(
                0, min(self.max_unrolling, admissible) + 1))
            self._t_batch[bi] = depth
        return iter(self._batches)

    def get_t_batch(self, batch_idx):
        return self._t_batch.get(batch_idx, 0)
