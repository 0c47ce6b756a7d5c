"""Modern U-Net on twophase (parity:
``src/configs/train/cfg_twophase_unet.py``).

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
    processor="UNetModern",
    ch_mults=[2, 2, 1, 2],
    is_attn=[False for _ in range(4)],
    mid_attn=False,
    hidden_features=32,
    norm=True,
    use1x1=True,
    cond_mode="concat",
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
