"""Seeding (counterpart of ``nps_tpu/utils/seed.py``): seeds python, numpy
and torch's global generators and records the seed, from which the trainer
seeds its own ``torch.Generator``s. Parameter init takes an explicit
``torch.Generator`` instead (see ``models.initializers``)."""

import os
import random

import numpy as np
import torch

_GLOBAL_SEED = 0


def set_seed(seed=1234):
    global _GLOBAL_SEED
    _GLOBAL_SEED = int(seed)
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)


def get_seed():
    return _GLOBAL_SEED
