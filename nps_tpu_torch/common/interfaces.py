"""Framework "type system": data-shape and model-kind enums.

Counterpart of ``nps_tpu/common/interfaces.py``: every dataset declares a
``data_interface``, every model a ``model_interface`` plus the data
interfaces it supports. The models carry the two as class attributes; the
JAX package's ``ModelInterface`` base class (``models/base.py``), which
only sets them to None and (), has no counterpart here.
"""

from enum import Enum


class D(Enum):
    """Data interface: the shape contract of one dataset element."""

    sim1d = 0        # (c, t, x)
    sim2d = 1        # (c, t, x, y)
    sim1d_var_t = 2  # (c, t, x) with per-element t


class M(Enum):
    """Model interface: the calling convention of a model family."""

    AR_TB_GNN = 0  # autoregressive + temporal bundling + GNN
    AR_TB = 1      # autoregressive + temporal bundling
