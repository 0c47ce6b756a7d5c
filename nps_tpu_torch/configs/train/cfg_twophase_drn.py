"""Dilated ResNet on twophase (parity:
``src/configs/train/cfg_twophase_drn.py``).

``dec_kernel_size`` and ``dec_padding_mode`` are kept as the reference has
them; no component declares them, so the kwarg filter drops them, as in the
JAX package."""

from nps_tpu_torch.configs.parse_component import load_config_modules, compose_config
from nps_tpu_torch.configs.train._twophase_shared import (
    make_base, make_dataset, make_trainer, make_wrapper)
from nps_tpu_torch.models.activations import GELU, Tanh

base_args, parser = make_base()

model = dict(
    make_wrapper(base_args, Tanh()),
    activation=GELU(),
    processor="DilatedResnet",
    kernel_size=5,
    hidden_blocks=2,
    hidden_features=128,
    padding_mode="circular",
    dec_kernel_size=5,
    dec_padding_mode="circular",
)

_, optimizer, lr_scheduler, _, criterion, _ = load_config_modules(base_args)

compose_config(parser,
               base_args=base_args,
               dataset=make_dataset(base_args),
               optimizer=optimizer.Adam,
               lr_scheduler=lr_scheduler.MultiStepLR,
               model=model,
               criterion=criterion.MSE_sum,
               trainer=make_trainer(base_args))
