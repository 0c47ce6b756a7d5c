"""The model's compute dtype (counterpart of ``nps_tpu/models/config.py``).

``compute_dtype`` selects the type activations flow in through the conv,
matmul and spectral paths; parameters stay f32 and every sum is taken in
f32 (cuDNN and cuBLAS accumulate bf16 products in f32, the hand kernels sum
in f32):

- None / "float32": full f32, the type of every parity bar;
- "bfloat16": activations in bf16, half the bytes of the memory-bound
  norm, activation and concat work. Normalisation statistics and the
  physics wrapper stay in f32.

It is read when a model runs, not when it is built:

    from nps_tpu_torch.models import config
    config.set_compute_dtype("bfloat16")            # for the process
    with config.compute_dtype_scope("bfloat16"):    # or for a block
        ...

The serving engine keeps its own compute dtype (its config's
``trainer.compute_dtype`` or its ``compute_dtype`` argument) and runs every
model apply inside :func:`compute_dtype_scope`; so does the trainer, for
its steps (backward included), evaluations and rollouts. A block that
:func:`~nps_tpu_torch.models.common.remat_block` rematerializes is
recomputed in the dtype its forward ran in.

One more switch, the JAX package's: :func:`fast_forward_scope` /
:func:`fast_forward_active`. Inside the block the model apply is a no-grad
pushforward step whose output only becomes the next train window's input,
so modules may take cheaper numerics; the trainer opens it around its
pushforward loop when ``trainer.pushforward_fast`` is set. There the exact
GELU (``activations.GELU``, and the fused GroupNorm+GELU's exact form)
becomes the tanh-approximate one. The JAX package also takes bf16
GroupNorm statistics there for bf16 inputs; the port keeps the f32
statistics of the K2 kernel (``ops/group_norm.py``).

The JAX package's ``set_gn_stats_impl``/``gn_stats_impl`` have no
counterpart here: K2's f32 sums are the only GroupNorm statistics on the
card.
"""

from contextlib import contextmanager

import torch

_COMPUTE_DTYPE = None


def resolve_compute_dtype(dtype):
    """The torch dtype (or None for f32) that a compute-dtype spelling
    names; the JAX package's spellings, a ValueError on any other."""
    if dtype in (None, "float32", "f32", torch.float32):
        return None
    if dtype in ("bfloat16", "bf16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"Unsupported compute dtype {dtype!r}")


def set_compute_dtype(dtype):
    global _COMPUTE_DTYPE
    _COMPUTE_DTYPE = resolve_compute_dtype(dtype)


def compute_dtype():
    return _COMPUTE_DTYPE


@contextmanager
def compute_dtype_scope(dtype):
    """Set the compute dtype inside the block and restore the caller's
    after it."""
    global _COMPUTE_DTYPE
    prev = _COMPUTE_DTYPE
    _COMPUTE_DTYPE = resolve_compute_dtype(dtype)
    try:
        yield
    finally:
        _COMPUTE_DTYPE = prev


def cast_compute(x):
    """Cast an activation tensor to the compute dtype (no-op under f32)."""
    dt = _COMPUTE_DTYPE
    if dt is not None and x.dtype != dt:
        return x.to(dt)
    return x


_FAST_FORWARD = False


def fast_forward_active():
    """Whether the current model apply is a no-grad pushforward step
    (:func:`fast_forward_scope`)."""
    return _FAST_FORWARD


@contextmanager
def fast_forward_scope(enabled=True):
    """Set :func:`fast_forward_active` to ``enabled`` inside the block and
    restore the caller's value after it, an exception included."""
    global _FAST_FORWARD
    prev = _FAST_FORWARD
    _FAST_FORWARD = bool(enabled)
    try:
        yield
    finally:
        _FAST_FORWARD = prev
