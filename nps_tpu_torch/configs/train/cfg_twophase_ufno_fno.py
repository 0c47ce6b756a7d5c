"""FNO -> U-FNO processor chain on twophase (parity:
``src/configs/train/cfg_twophase_ufno_fno.py``): an FNO and a U-FNO processor
of one block each, sharing the remaining parameters. The FNO has no
``activation`` field, so its layer applies the default exact GELU."""

from nps_tpu_torch.configs.parse_component import load_config_modules, compose_config
from nps_tpu_torch.configs.train._twophase_shared import (
    make_base, make_dataset, make_trainer, make_wrapper)
from nps_tpu_torch.models.activations import GELU, Tanh

base_args, parser = make_base()

model = dict(
    make_wrapper(base_args, Tanh()),
    activation=GELU(),
    hidden_blocks=1,
    processor=[dict(object="FNO"),
               dict(object="UFNO")],
    fno_modes=10,
    hidden_features=192,
    fno_kernel_size=1,
    fno_conv_mode="single",
    padding_mode="circular",
    ch_mults=[1, 1],
    is_attn=[False for _ in range(2)],
    mid_attn=False,
    norm=True,
    use1x1=True,
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
