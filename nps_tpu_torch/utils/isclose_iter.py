"""Recursive approximate equality over dicts, lists, arrays and tensors
(counterpart of ``nps_tpu/utils/isclose_iter.py``, with its tolerance
arguments; a tensor on any device is compared on the host)."""

import math

import numpy as np
import torch


def _host(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def isclose_iter(x, y, rtol=1e-5, atol=1e-8):
    if isinstance(x, dict) and isinstance(y, dict):
        if x.keys() != y.keys():
            return False
        return all(isclose_iter(x[k], y[k], rtol, atol) for k in x)
    if isinstance(x, (list, tuple)) and isinstance(y, (list, tuple)):
        if len(x) != len(y):
            return False
        return all(isclose_iter(a, b, rtol, atol) for a, b in zip(x, y))
    if isinstance(x, float) and isinstance(y, float):
        return math.isclose(x, y, rel_tol=rtol, abs_tol=atol)
    if hasattr(x, "shape") and hasattr(y, "shape"):
        x, y = _host(x), _host(y)
        return x.shape == y.shape and bool(np.allclose(x, y, rtol=rtol,
                                                       atol=atol))
    return x == y
