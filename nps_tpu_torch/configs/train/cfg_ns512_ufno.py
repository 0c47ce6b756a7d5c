"""2D Navier-Stokes-scale flow at 512^2 with a U-FNO: 3 blocks x 128
features, 20x20 modes, ``ch_mults`` [1, 1, 1], tanh-approximate GELU, bf16
compute, batch 8 (mirror of ``nps_tpu/configs/train/cfg_ns512_ufno.py``,
key for key).

Serve it on one card with ``SurrogateEngine.from_config`` (bf16 from
``trainer.compute_dtype``), and train it on one card with the training CLI
as it is: ``data_parallel=True`` in one process is the single-device step,
as the JAX trainer's mesh over one device is; in a world of several
processes (``--trainer.distributed``) each rank trains on its slice of the
global batch of 8. Gradient accumulation (``trainer.grad_accum=2``: the gradients of
two batches of 8 averaged before each Adam step, the effective batch 16
without the memory) has no key here, as in the JAX config, so the flag
``--trainer.grad_accum`` is not accepted; a caller sets it on the trainer's
config before the optimizer is built. It trains in bf16 with f32 parameters and Adam state, each block's FNO layer and U-Net rematerialized
with the ``save_conv_outputs`` policy. Neither the trainer nor the engine
reads ``trainer.device``. Generate a synthetic dataset at this shape with
the port's generator:

    from nps_tpu_torch.data.synthetic import generate
    generate("$DATAROOT/ns512", n_sims=64, n_channels=1, nt=101,
             nx1=512, nx2=512)
"""

from nps_tpu_torch.configs.parse_component import load_config_modules, compose_config
from nps_tpu_torch.configs.parse import parse_arg_default  # noqa: F401 (flag types)
from nps_tpu_torch.configs.train.defaults import base
from nps_tpu_torch.configs.parse_component import parse_base
from nps_tpu_torch.models.activations import GELUTanh, Tanh

base_args_dict = {**base.default, **dict(
    base_resolution=(101, 512, 512),
    super_resolution=(101, 512, 512),
    experiment="ns512",
    time_window=25,
    batch_size=8,
)}
base_args, parser = parse_base(base_args_dict)

dataset = dict(
    object="PDE2DDataset",
    base_path=base_args.data_path,
    experiment=base_args.experiment,
    split_file="split",
    data_format="memmap",
    data_file="snapshots",
    conditioning="conditioning",
    spatial_conditioning="spatial_conditioning",
    name="ns512",
    preprocess=False,
    c_filter=[0],
)

trainer = dict(
    object="AutoregressivePushforwardTrainer",
    neighbors=3,
    time_window=base_args.time_window,
    base_resolution=base_args.base_resolution,
    super_resolution=base_args.super_resolution,
    device="tpu",
    batch_size=base_args.batch_size,
    nr_gt_steps=1,
    nw=0,
    num_epochs=500,
    lr_step_interval=25,
    unrolling=4,
    print_interval=4,
    test_interval=25,
    max_train_batches=float("inf"),
    max_test_batches=float("inf"),
    print_setting=dict(print_per_step=False),
    process_settings={},
    # the JAX package's multi-device layout: in one process the single-device
    # step, in a world of several one process a device
    data_parallel=True,
    spatial_parallel=0,  # set K>1 for the ("data", "x") grid mesh
    dynamic_unroll=True,  # one compiled step for every unroll depth
    # a bf16 train-only device cache when switched on (the 52-sim train
    # split is 5.5 GB in f32); evaluation reads the f32 host path
    device_cache=False,
    device_cache_scope="train",
    device_cache_dtype="bfloat16",
    eval_batch_size=0,  # 0 -> batch_size; eval has no opt state resident
    matmul_precision=None,
    compute_dtype="bfloat16",
    resume=True,
    checkpoint_interval=None,  # None -> test_interval
    eval_only=False,
    load_model=None,
)

model = dict(
    object="activation_wrapper",
    activation_final=Tanh(),
    enforce_spatial_cond=False,
    spatial_cond_channel=0,
    approx_volume_preserve=False,
    approx_volume_preserve_mode="individual_static",
    max_pct_dif=1 / 25,
    model_class="EncProcDec",
    num_c=1,
    num_spatial_dims=2,
    time_window=base_args.time_window,
    data_structure="grid",
    processor_residual=False,
    encoder="enc_grid.ElementWise",
    # tanh-approximate GELU, as the JAX config sets it (no reference
    # mirror): the GN kernel normalises and the activation follows
    activation=GELUTanh(),
    processor="UFNO",
    fno_modes=20,
    hidden_blocks=3,
    hidden_features=128,
    fno_kernel_size=1,
    fno_conv_mode="single",
    padding_mode="circular",
    ch_mults=[1, 1, 1],
    is_attn=[False for _ in range(3)],
    mid_attn=False,
    norm=True,
    use1x1=True,
    remat=True,
    # keep the conv outputs, recompute the elementwise and norm work
    remat_policy="save_conv_outputs",
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
