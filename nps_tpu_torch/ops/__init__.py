"""Ops that hold a hand-written kernel: each has its plain PyTorch version
(taken for CPU tensors) and its kernel wrapper (taken for CUDA tensors).
Importing the package registers the forward kernels as custom ops
(:mod:`nps_tpu_torch.ops.library`)."""

from nps_tpu_torch.ops import library  # noqa: F401
