"""Trainer namespace (counterpart of ``nps_tpu/train``): the trainer classes
the training CLI resolves by name, and the loss and optimizer registries."""

from nps_tpu_torch.train.base import TrainInterface  # noqa: F401
from nps_tpu_torch.train.pushforward import AutoregressivePushforwardTrainer  # noqa: F401
from nps_tpu_torch.train.losses import build_criterion  # noqa: F401
from nps_tpu_torch.train.optim import build_optimizer, build_lr_scheduler  # noqa: F401
