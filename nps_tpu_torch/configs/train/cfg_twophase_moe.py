"""Mixture-of-spectral-experts FNO on twophase (counterpart of
``nps_tpu/configs/train/cfg_twophase_moe.py``; the reference has no MoE).

A conditioning-gated mixture of spectral experts
(``nps_tpu_torch/models/moe_fno.py``): 3 blocks of 4 FNO-layer experts at
192 features and 10x10 modes, the gate on the static conditioning, the
tanh-approximate GELU after each mixture. One device trains it
(``expert_parallel`` 0 or 1); ``expert_parallel=K`` with
``data_parallel`` splits the experts over a (data, expert) grid of
processes (``parallel/expert.py``), and ``spatial_parallel=K`` splits the
fields' rows over a (data, x) grid (``parallel/spatial.py``).
"""

from nps_tpu_torch.configs.parse_component import load_config_modules, compose_config
from nps_tpu_torch.configs.train._twophase_shared import (
    make_base, make_dataset, make_trainer, make_wrapper)
from nps_tpu_torch.models.activations import GELUTanh, Tanh

base_args, parser = make_base()

model = dict(
    make_wrapper(base_args, Tanh()),
    activation=GELUTanh(),
    processor="MoEFNO",
    n_experts=4,
    fno_modes=10,
    hidden_blocks=3,
    hidden_features=192,
    fno_kernel_size=1,
    fno_conv_mode="single",
    padding_mode="circular",
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
