"""1D variable-length simulations with an FNO (``D.sim1d_var_t``; mirror of
``nps_tpu/configs/train/cfg_var1d_fno.py``, key for key): 2 blocks x 64
features, 8 modes, time window 5, batch 8, on ragged storage through the
bucketing batch sampler (min-crop for training, max-pad with masked
evaluation) and pushforward training at each batch's admissible unroll
depths.

Train it with the training CLI, on the card, or on the CPU with
``--device cpu``; neither the trainer nor the engine reads
``trainer.device``. Generate a synthetic dataset with the port's generator:

    from nps_tpu_torch.data.synthetic import generate_var_t
    generate_var_t("$DATAROOT/var1d", n_sims=64)
"""

from nps_tpu_torch.configs.parse_component import (load_config_modules,
                                                   compose_config, parse_base)
from nps_tpu_torch.configs.train.defaults import base
from nps_tpu_torch.models.activations import GELU

base_args_dict = {**base.default, **dict(
    base_resolution=(100, 32),
    super_resolution=(100, 32),
    experiment="var1d",
    time_window=5,
    batch_size=8,
    num_c=2,
)}
base_args, parser = parse_base(base_args_dict)

dataset = dict(
    object="PDE1DVarTDataset",
    base_path=base_args.data_path,
    experiment=base_args.experiment,
    split_file="split",
    data_file="snapshots",
    conditioning="conditioning",
    name="var1d",
)

trainer = dict(
    object="AutoregressivePushforwardTrainer",
    neighbors=3,
    time_window=base_args.time_window,
    base_resolution=base_args.base_resolution,
    super_resolution=base_args.super_resolution,
    device="cpu",
    batch_size=base_args.batch_size,
    nr_gt_steps=1,
    nw=0,
    num_epochs=100,
    lr_step_interval=10,
    unrolling=2,
    print_interval=4,
    test_interval=10,
    max_train_batches=float("inf"),
    max_test_batches=float("inf"),
    print_setting=dict(print_per_step=False),
    process_settings={},
    sampler=dict(object="VariableTimeBatchSampler", with_replacement=True),
    data_parallel=False,
    # a JAX compile switch (one compiled step for every depth); the port
    # runs each depth eagerly, so the key is kept and not read
    dynamic_unroll=True,
    eval_batch_size=0,  # 0 -> batch_size
    matmul_precision=None,
    compute_dtype=None,
    resume=False,
    checkpoint_interval=None,  # None -> test_interval
    # "auto" (a launcher's env://) or "host:port,N,i" for several
    # processes, with data_parallel=True
    distributed="",
    eval_only=False,
    load_model=None,
)

model = dict(
    object="EncProcDec",
    num_c=base_args.num_c,
    num_spatial_dims=1,
    time_window=base_args.time_window,
    data_structure="grid",
    processor_residual=False,
    encoder="enc_grid.ElementWise",
    activation=GELU(),
    processor="FNO",
    fno_modes=8,
    hidden_blocks=2,
    hidden_features=64,
    fno_kernel_size=1,
    fno_conv_mode="single",
    padding_mode="circular",
    decoder="dec_grid.TimeConvDense",
    dec_delta_mode="per_step",
)

_, optimizer, lr_scheduler, _, criterion, _ = load_config_modules(base_args)

compose_config(parser,
               base_args=base_args,
               dataset=dataset,
               optimizer=optimizer.Adam,
               lr_scheduler=lr_scheduler.MultiStepLR,
               model=model,
               criterion=criterion.MSE_sum,
               trainer=trainer)
