"""Training CLI (counterpart of ``nps_tpu/train_cli.py``).

    python -m nps_tpu_torch.train_cli \\
        -C nps_tpu_torch/configs/train/cfg_twophase_ufno.py \\
        [--device cuda|cpu] [--group.key=value ...]

Wires config -> dataset -> model -> criterion -> trainer, runs a pre-train
sanity evaluation on the validation split, builds the optimizer, trains,
pickles the loss summary and runs the final test evaluation. It runs on the
GPU unless ``--device cpu`` is given, and refuses to start without a CUDA
device otherwise; the config's ``trainer.device`` is not read. Overrides use
the JAX package's flag semantics (``nps_tpu_torch.configs.parse``).

Several processes, one device each (data parallelism,
``nps_tpu_torch.parallel``), as the JAX CLI's ``--trainer.distributed``:

    torchrun --nproc_per_node=N -m nps_tpu_torch.train_cli -C CFG \\
        --trainer.distributed=auto --trainer.data_parallel=true

(``auto`` reads the launcher's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``), or one process per rank started by
hand with ``--trainer.distributed=host:port,N,i`` (rank i of N, rank 0
listening on host:port). The backend is NCCL on CUDA and gloo on the CPU.
Add ``--trainer.spatial_parallel=K`` for spatial parallelism: the N
processes form a (data, x) grid of N / K data slices of K ranks, each
holding 1 / K of the rows of every field (``nps_tpu_torch.parallel.spatial``):

    torchrun --nproc_per_node=N -m nps_tpu_torch.train_cli -C CFG \
        --trainer.distributed=auto --trainer.data_parallel=true \
        --trainer.spatial_parallel=K

or, in its place, ``--trainer.tensor_parallel=K`` (each rank holds 1 / K of
the output channels of the split weights, ``parallel.tensor``),
``--trainer.pipeline_parallel=K`` with ``--trainer.pipeline_microbatches=M``
(the processor's stages streamed over K ranks, ``parallel.pipeline``) or
``--trainer.expert_parallel=K`` (the MoE's experts split over K ranks,
``parallel.expert``): a (data, model), (data, pipe) or (data, expert) grid.
"""

import os
import pickle
import sys
import tempfile
from argparse import Namespace
from datetime import datetime

import torch

import nps_tpu_torch.data as data
import nps_tpu_torch.models as models
import nps_tpu_torch.train as trainers
from nps_tpu_torch import parallel
from nps_tpu_torch.configs.parse import parse_args
from nps_tpu_torch.data.memmap_dataset import SCRATCH_ENV
from nps_tpu_torch.inference import resolve_device
from nps_tpu_torch.train.losses import build_criterion
from nps_tpu_torch.utils import misc as util

PRINT_ARGS = True


def get_config_static(args, lazy_init=True, model_override=None,
                      device="cuda"):
    """Build (dataset, model_name, model, criterion, trainer, optimizer,
    lr_scheduler) from parsed ``args``; the trainer runs on ``device``."""
    dataset = getattr(data, args["dataset"].pop("object"))(**args["dataset"])

    model_name = args["model"]["object"]
    model = getattr(models, args["model"].pop("object"))(
        **args["model"], pde=dataset.pde)
    if model_override is not None:
        model = model_override

    criterion = build_criterion(**dict(args["criterion"]))
    args["criterion"].pop("object", None)

    config = Namespace(**args["trainer"])
    if args["experiment_name"] is None:
        now = datetime.now()
        timestring = (f"{now.date().month}{now.date().day}{now.time().hour}"
                      f"{now.time().minute}{now.time().microsecond}")
        args["experiment_name"] = f"{dataset.pde}_{model_name}_{timestring}"
    save_path = os.path.join(args["experiment_path"], args["experiment_name"])

    use_wandb = args["use_wandb"]
    wandb_config_dict = {}
    if use_wandb:
        for k, v in args.items():
            wandb_config_dict[k] = dict(v) if isinstance(v, dict) else v

    epoch_callback = args["trainer"].pop("epoch_callback", None)
    trainer = getattr(trainers, args["trainer"].pop("object"))(
        model=model, data=dataset, config=config, criterion=criterion,
        optimizer=None, lr_scheduler=None, save_path=save_path,
        epoch_callback=epoch_callback, use_wandb=use_wandb,
        wandb_kwargs=args["wandb_kwargs"],
        wandb_config_dict=wandb_config_dict, device=device)

    optimizer = lr_scheduler = None
    if not lazy_init:
        optimizer = dict(args["optimizer"])
        lr_scheduler = dict(args["lr_scheduler"])
        trainer.set_optimizer(optimizer)
        trainer.set_lr_scheduler(lr_scheduler)
    return (dataset, model_name, model, criterion, trainer, optimizer,
            lr_scheduler)


def init_from_flag(flag, device):
    """Join the process group that ``--trainer.distributed`` names (see the
    module note) and print the process line; return this rank's device, or
    ``device`` where the flag asks for one process."""
    flag = str(flag or "")
    if flag.lower() in ("", "false", "0", "none"):
        return device
    if flag.lower() in ("auto", "true", "1"):
        device = parallel.init_distributed("env://", device=device)
    else:
        coord, n_proc, proc_id = flag.split(",")
        device = parallel.init_distributed(
            f"tcp://{coord}", world_size=int(n_proc), rank=int(proc_id),
            device=device)
    rank, size = parallel.world()
    print(f"Distributed: process {rank} of {size}, backend "
          f"{torch.distributed.get_backend()}, device {device}")
    return device


def main(args, device="cuda"):
    device = resolve_device(device)
    device = init_from_flag(args.get("trainer", {}).get("distributed"),
                            device)
    if PRINT_ARGS:
        print(util.dict_str(args, prefix="--", mapping="="))
    os.makedirs(args["experiment_path"], exist_ok=True)

    dataset, model_name, model, criterion, trainer, _, _ = \
        get_config_static(args, lazy_init=True, device=device)
    print(f"Save path set to {trainer.config.save_path}")
    print(f"Loaded device: {trainer.device}")

    print("Sanity check on validation data...")
    _, valid_loader, test_loader = trainer.get_dataloaders()
    sample = next(iter(valid_loader))
    print("shape of one datapoint: (bs, channels, time, *spatial)",
          tuple(sample[1].shape))
    valid_loss, valid_summary = trainer.test(valid_loader)
    print("Pre-train valid summary:")
    print(util.dict_str(util.to_floatdict(valid_summary), prefix=" • "))

    if getattr(trainer.config, "eval_only", False):
        # --trainer.eval_only=true [--trainer.load_model=path/to.pt]
        load = getattr(trainer.config, "load_model", None)
        if load:
            trainer.load_model(load)
            print(f"Loaded model from {load}")
        summary = {}
        for name, tk in trainer.test_kwargs_list:
            for split, loader in (("valid", valid_loader),
                                  ("test", test_loader)):
                if callable(tk):
                    loss, stats = tk(loader, trainer)
                else:
                    loss, stats = trainer.test(loader, test_kwargs=tk)
                loss = util.to_float(loss)
                stats = util.to_floatdict(stats)
                print(f"[{name}/{split}] loss: {loss}")
                print(util.dict_str(stats, prefix=" • "))
                summary[f"{name}/{split}"] = dict(loss=loss, **stats)
        if trainer._is_writer_process():
            with open(os.path.join(args["experiment_path"],
                                   args["experiment_name"]
                                   + "_eval_summary.pickle"), "wb") as f:
                pickle.dump(summary, f)
        print("Eval Completed!")
        return trainer

    # optimizer and scheduler after the first forward pass, as upstream
    trainer.set_optimizer(dict(args["optimizer"]))
    trainer.set_lr_scheduler(dict(args["lr_scheduler"]))
    if args["function_pre"] is not None:
        print("\n\nRunning pre-training callable")
        args["function_pre"](args, dataset, None, None, model, criterion,
                             trainer)

    print("\n\n----Start training----")
    print("Number of parameters:", util.count_parameters(trainer.model))
    train_losses, val_losses, val_stats = trainer.train()
    if trainer.preempted:
        # a full checkpoint was saved; 128 + SIGTERM tells an orchestrator
        # to reschedule the job, which resumes with --trainer.resume=true
        print("Run preempted — resume with --trainer.resume=true")
        sys.exit(143)
    print("Train losses:", util.to_floatlist(train_losses))
    first = list(val_losses.keys())[0]
    print("Validation losses:", util.to_floatlist(val_losses[first]))
    if trainer._is_writer_process():
        with open(os.path.join(args["experiment_path"],
                               args["experiment_name"]
                               + "_train_summary.pickle"), "wb") as f:
            pickle.dump(dict(train_losses=train_losses,
                             val_losses=val_losses, val_stats=val_stats), f)

    test_loss, test_summary = trainer.test(test_loader)
    print("Test loss:", util.to_float(test_loss))
    print("Test summary:")
    print(util.dict_str(util.to_floatdict(test_summary), prefix=" • "))
    if args["function_post"] is not None:
        print("\n\nRunning post-training callable")
        args["function_post"](args, dataset, None, None, model, criterion,
                              trainer)
    print("Run Completed!")
    return trainer


def pop_device(argv):
    """Remove ``--device X`` / ``--device=X`` from ``argv``; return
    (device, argv) with "cuda" when it is absent."""
    out, device, i = [], "cuda", 0
    while i < len(argv):
        a = argv[i]
        if a == "--device":
            device = argv[i + 1]
            i += 2
            continue
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            out.append(a)
        i += 1
    return device, out


def cli(argv=None):
    """Parse ``argv`` (default ``sys.argv``) and run inside a scratch
    directory that the dataset's preprocessing writes to and that is removed
    afterwards, whatever happens; leave the process group, if the run joined
    one. Returns the trainer."""
    device, argv = pop_device(list(sys.argv if argv is None else argv))
    resolve_device(device)
    saved_argv, sys.argv = sys.argv, argv
    saved_stdout = sys.stdout
    try:
        args = parse_args()
        sys.stdout = util.Logger(saved_stdout, write_log=False)
        with tempfile.TemporaryDirectory(prefix="nps_torch_") as scratch:
            prev = os.environ.get(SCRATCH_ENV)
            os.environ[SCRATCH_ENV] = scratch
            try:
                trainer = main(args, device)
            finally:
                if prev is None:
                    os.environ.pop(SCRATCH_ENV, None)
                else:
                    os.environ[SCRATCH_ENV] = prev
    finally:
        sys.argv, sys.stdout = saved_argv, saved_stdout
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    print("Run finished!")
    return trainer


if __name__ == "__main__":
    cli()
