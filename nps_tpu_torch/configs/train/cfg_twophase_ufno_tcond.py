"""U-FNO on twophase with time conditioning: ``cfg_twophase_ufno`` plus the
dataset's ``t_conditioning`` memmap (``[n_sims, n_dyn, nt]``, the same
frames as the snapshots) and a BC encoder whose code of each window's
conditioning joins the static conditioning, so every processor's input
grows by ``bc_encoder_out`` channels.

No reference or JAX config ships this model; its dicts are those of
``cfg_twophase_ufno`` with the two entries below, which the JAX package's
trainer takes as they are. The shipped twophase data has no
``t_conditioning`` file: write one beside the snapshots, or point
``--dataset.t_conditioning`` at another name in the dataset's directory.
"""

from nps_tpu_torch.configs.parse_component import load_config_modules, compose_config
from nps_tpu_torch.configs.train._twophase_shared import (
    make_base, make_dataset, make_trainer, make_wrapper)
from nps_tpu_torch.models.activations import GELU, Tanh

base_args, parser = make_base()

model = dict(
    make_wrapper(base_args, Tanh()),
    activation=GELU(),
    processor="UFNO",
    fno_modes=10,
    hidden_blocks=3,
    hidden_features=192,
    fno_kernel_size=1,
    fno_conv_mode="single",
    padding_mode="circular",
    ch_mults=[1, 1],
    is_attn=[False for _ in range(2)],
    mid_attn=False,
    norm=True,
    use1x1=True,
    bc_encoder=dict(object="BCEncoder", bc_encoder_out=8,
                    bc_encoder_hidden=32, bc_encoder_kernel=3,
                    bc_encoder_n_hidden=1),
)

_, optimizer, lr_scheduler, _, criterion, _ = load_config_modules(base_args)

compose_config(parser,
               base_args=base_args,
               dataset=dict(make_dataset(base_args),
                            t_conditioning="t_conditioning"),
               optimizer=optimizer.Adam,
               lr_scheduler=lr_scheduler.MultiStepLR,
               model=model,
               criterion=criterion.MSE_sum,
               trainer=make_trainer(base_args))
