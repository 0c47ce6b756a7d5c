"""Generic batch slicing over arrays, tensors, lists and dicts (counterpart
of ``nps_tpu/utils/slice_batch.py``): select a sub-batch from
heterogeneous batch structures."""

import numpy as np


def handle_item(item, idx):
    if item is None:
        return None
    if isinstance(item, dict):
        return {k: handle_item(v, idx) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(handle_item(v, idx) for v in item)
    if hasattr(item, "shape"):
        return item[idx]
    return item


def index_batch(batch, idx):
    """Index every array-like leaf of ``batch`` along its leading dim."""
    if isinstance(idx, int):
        idx = np.array([idx])
    return tuple(handle_item(item, idx) for item in batch)
