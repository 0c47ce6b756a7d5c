"""Criterion registry (counterpart of ``nps_tpu/train/losses.py``): the
config's dotted names (``nn.MSELoss`` with ``reduction="sum"``) and plain
aliases map to loss functions on tensors."""

import torch


def _reduce(d, reduction):
    if reduction == "sum":
        return torch.sum(d)
    if reduction == "mean":
        return torch.mean(d)
    if reduction == "none":
        return d
    raise ValueError(f"Unknown reduction {reduction}")


def mse(pred, target, reduction="sum"):
    return _reduce((pred - target) ** 2, reduction)


def l1(pred, target, reduction="sum"):
    return _reduce(torch.abs(pred - target), reduction)


_REGISTRY = {
    "nn.MSELoss": mse,
    "MSELoss": mse,
    "mse": mse,
    "nn.L1Loss": l1,
    "L1Loss": l1,
    "l1": l1,
}


def build_criterion(object=None, reduction="mean", **kwargs):
    """Build a criterion callable from a config group
    (e.g. ``dict(object="nn.MSELoss", reduction="sum")``)."""
    if callable(object):
        return object
    if object not in _REGISTRY:
        raise ValueError(f"Unknown criterion '{object}'; "
                         f"known: {sorted(_REGISTRY)}")
    fn = _REGISTRY[object]
    return lambda pred, target: fn(pred, target, reduction=reduction)
