"""Shared config groups for the twophase experiment family.

The four ``cfg_twophase_*`` configs (parity:
``src/configs/train/cfg_twophase_{drn,unet,ufno,ufno_fno}.py``) differ only
in their model dict; the base args, dataset and trainer groups are shared.
"""

from nps_tpu_torch.configs.parse_component import parse_base
from nps_tpu_torch.configs.train.defaults import base


def make_base():
    base_args_dict = {**base.default, **dict(
        base_resolution=(501, 96, 64),
        super_resolution=(501, 96, 64),
        experiment="twophase",
        time_window=25,
    )}
    return parse_base(base_args_dict)


def make_dataset(base_args):
    return dict(
        object="PDE2DDataset",
        base_path=base_args.data_path,
        experiment=base_args.experiment,
        split_file="split",
        data_format="memmap",
        data_file="snapshots",
        conditioning="conditioning",
        spatial_conditioning="spatial_conditioning",
        name="twophase",
        preprocess=False,
        c_filter=[6],
    )


def make_trainer(base_args):
    """The JAX package's trainer group, key for key, so both parsers give
    the same dicts. Neither the trainer nor the serving engine reads
    ``device``: the caller chooses the device."""
    return dict(
        object="AutoregressivePushforwardTrainer",
        neighbors=3,
        time_window=base_args.time_window,
        base_resolution=base_args.base_resolution,
        super_resolution=base_args.super_resolution,
        device="cpu",
        batch_size=base_args.batch_size,
        nr_gt_steps=1,
        nw=0,
        num_epochs=10 * 50,
        lr_step_interval=25,
        unrolling=8,
        print_interval=4,
        test_interval=25,
        max_train_batches=float("inf"),
        max_test_batches=float("inf"),
        print_setting=dict(print_per_step=True),
        process_settings={},
        data_parallel=False,
        spatial_parallel=0,
        tensor_parallel=0,
        pipeline_parallel=0,
        pipeline_microbatches=0,
        expert_parallel=0,
        zero1=False,
        grad_accum=0,
        pushforward_fast=False,
        dynamic_unroll=True,
        eval_batch_size=0,
        precompile_ahead=True,
        device_cache=False,
        device_cache_scope=None,
        device_cache_dtype=None,
        matmul_precision=None,
        compute_dtype=None,
        resume=False,
        checkpoint_interval=None,
        distributed="",
        eval_only=False,
        load_model=None,
    )


def make_wrapper(base_args, activation_final):
    """The physics activation-wrapper settings shared by all four configs."""
    return dict(
        object="activation_wrapper",
        activation_final=activation_final,
        enforce_spatial_cond=True,
        spatial_cond_channel=0,
        approx_volume_preserve=True,
        approx_volume_preserve_mode="individual_static",
        max_pct_dif=1 / 25,
        model_class="EncProcDec",
        num_c=1,
        num_spatial_dims=2,
        time_window=base_args.time_window,
        data_structure="grid",
        processor_residual=False,
        encoder="enc_grid.ElementWise",
        decoder="dec_grid.TimeConvDense",
        dec_delta_mode="per_step",
    )
