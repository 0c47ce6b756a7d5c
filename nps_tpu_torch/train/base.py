"""Training runtime backbone (counterpart of ``nps_tpu/train/base.py``), one
device: dataloaders, the epoch loop with periodic named validation ->
best-model save -> test-on-best, batch-size-weighted test aggregation, a
metrics JSON line per epoch, best/final model export, and a full
checkpoint with resume, written on schedule and on SIGTERM/SIGINT.

The device is the caller's (``device``, "cuda" unless asked otherwise); the
config's ``trainer.device`` is not read. The whole loop, backward included,
runs inside the engine's :func:`autotuned_convs`: left to its heuristics,
cuDNN picks an FFT algorithm for the U-Net's f32 convs that made a step of
the full-width U-FNO about 65x slower on an H100 (PERF.md).

The config's ``compute_dtype`` (the JAX package's spellings; f32 when
unset) is the trainer's: its steps, evaluations and rollouts run inside
:func:`~nps_tpu_torch.models.config.compute_dtype_scope` (methods marked
:func:`in_compute_dtype`), where the JAX trainer sets the process-wide
dtype. Parameters, gradients and Adam's state stay f32; so do the loss and
the physics wrapper's output.

``data_parallel=True`` trains in a world of one process per device
(``nps_tpu_torch.parallel``, the JAX trainer's "data" mesh): every rank
holds the replicated parameters (rank 0's, broadcast), trains on its slice
of each global batch from the multi-process loaders, and the optimizer
sums the gradients over the world (``parallel.AllReduceGrads``, or
``parallel.Zero1`` with ``zero1=True``, which shards the optimizer state);
the step's loss and evaluation are the global batch's (see
``train.pushforward``). Only rank 0 writes checkpoints, exports and
metrics; a stop signal to any rank stops every rank at the same batch
boundary. Without a process group it is the single-device step, as the
JAX trainer's mesh over the one device present is. ``grad_accum=N`` wraps
the optimizer in :class:`~nps_tpu_torch.train.optim.MultiSteps` (the JAX
trainer's ``optax.MultiSteps``); variable-time data (``D.sim1d_var_t``)
takes the batch sampler and the min-crop / max-pad loaders.

``spatial_parallel=K`` (with ``data_parallel``) lays the world of D x K
processes out as a (data, x) grid (``parallel.Grid``; the JAX trainer's
``make_grid_mesh``): rank (d, s) trains on data slice d of each global
batch (``rank`` and ``world`` are d and D) and holds rows [s X / K,
(s + 1) X / K) of every field, and the model applies run inside
``parallel.scope`` of the x axis, where the ops whose result crosses rows
take their halos and partial sums from the x group. The optimizer's sum
over the world adds the data slices' and the x ranks' shares of every
gradient. The 2D and 3D grid families split so
(``parallel.spatial.check``); the MP-GNN and the 1D models run whole on
each x rank (their batch uncut, their gradients summed over the data
group, said on a log line); rows that do not split over K * 2^levels of
the U-Net raise.

``tensor_parallel``, ``pipeline_parallel`` (with ``pipeline_microbatches``)
and ``expert_parallel`` = K (with ``data_parallel``) lay the world out as a
(data, model), (data, pipe) or (data, expert) grid the same way
(``parallel.Grid``); rank (d, s) trains on data slice d, and the model
applies run inside ``parallel.scope`` of the axis, whose regime reads it:
``parallel.tensor`` (each rank holds its share of the split weights' output
channels), ``parallel.pipeline`` (the processor's stages streamed over the
pipe group, the parameters replicated) or ``parallel.expert`` (each rank
holds its experts). The trainer reaches each regime through the same hooks
of its module (:data:`_REGIME_MODULES`). Each parameter is tagged once, by
the modules that own it (the regime's ``partial_params``;
:meth:`TrainInterface._grad_sums`): ``whole`` (the same gradient, or the
gradient of its own shard, on every axis rank: summed over the data group)
or ``partial`` (a part on each axis rank: summed over the world). The step's
loss and evaluation sum over the data group, whose axis ranks hold the same
values. A regime combines with data parallelism only (a second regime
raises); ``zero1`` is refused under tensor and expert parallelism, as in
the JAX package. Parameters are a ``state_dict`` of the PyTorch reference's
key names (``.pt``), which ``nps_tpu.compat.convert_state_dict`` reads; a
sharded model's, and its optimizer state, are gathered whole before they
are written.
"""

import functools
import json
import os
import random as py_random
import signal
import time
import warnings
from abc import ABCMeta, abstractmethod
from argparse import Namespace

import numpy as np
import torch
import torch.distributed as dist

from nps_tpu_torch import parallel
from nps_tpu_torch.common.interfaces import D
from nps_tpu_torch.compat.jax_weights import from_jax_params
from nps_tpu_torch.data.pipeline import (DeviceCacheLoader, HostDataLoader,
                                         VariableTimeLoader,
                                         prefetch_to_device)
from nps_tpu_torch.data.samplers import VariableTimeBatchSampler
from nps_tpu_torch.inference import autotuned_convs, resolve_device
from nps_tpu_torch.models.config import (compute_dtype_scope,
                                         resolve_compute_dtype)
from nps_tpu_torch.parallel import expert, pipeline, spatial, tensor
from nps_tpu_torch.parallel.multihost import AXIS_KEYS
from nps_tpu_torch.models.initializers import reset_parameters
from nps_tpu_torch.train import optim as optim_lib
from nps_tpu_torch.utils import misc as util
from nps_tpu_torch.utils.seed import get_seed

try:
    import wandb
except ModuleNotFoundError:
    wandb = None

# each grid axis: (what the regime does, its item of ROADMAP P9b)
_REGIMES = {"x": ("spatial parallelism", 3),
            "model": ("tensor parallelism", 4),
            "pipe": ("pipeline parallelism", 5),
            "expert": ("expert parallelism", 6)}
# each grid axis's module, with the trainer's hooks of its regime: check,
# setup, partial_params (and under tensor and expert parallelism, whose
# setup returns the specs of the split weights, shard_state and merge)
_REGIME_MODULES = {"x": spatial, "model": tensor, "pipe": pipeline,
                   "expert": expert}


def world_size():
    """The processes of this run: the initialised ``torch.distributed``
    group's size, or ``WORLD_SIZE`` as a launcher sets it, the larger."""
    group = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    return max(group, int(os.environ.get("WORLD_SIZE") or 1))


def grid_axis(config):
    """(axis name, K) of the config's grid regime (a value above 1), or
    None; two regimes raise ``NotImplementedError`` naming their items:
    each composes with data parallelism only."""
    asked = [(name, int(getattr(config, key, 0) or 0))
             for name, key in AXIS_KEYS.items()
             if int(getattr(config, key, 0) or 0) > 1]
    if len(asked) > 1:
        raise NotImplementedError(
            " and ".join(f"{AXIS_KEYS[n]}={k} ({_REGIMES[n][0]}, ROADMAP "
                         f"P9b item {_REGIMES[n][1]})" for n, k in asked)
            + ": each composes with data parallelism only; set one")
    return asked[0] if asked else None


def refuse_unported(config):
    """Raise for a config the port cannot train as asked: two grid regimes
    at once (``NotImplementedError`` naming their ROADMAP P9b items), a
    regime or ``zero1`` without data parallelism, ``zero1`` under tensor or
    expert parallelism (``ValueError``), a regime without a process group
    (``RuntimeError`` naming its item), and a world of more than one process
    without data parallelism or without a process group (each process would
    train its own model; ``ValueError``, ``RuntimeError``). A regime of 0
    or 1 is the single-device step."""
    regime = grid_axis(config)
    dp = bool(getattr(config, "data_parallel", False))
    if regime is not None:
        name, k = regime
        key, (what, item) = AXIS_KEYS[name], _REGIMES[name]
        if not dp:
            raise ValueError(
                f"{key}={k} splits the world into a (data, {name}) grid of "
                f"processes: enable trainer.data_parallel")
        if getattr(config, "zero1", False) and name in ("model", "expert"):
            raise ValueError(
                f"zero1 is redundant under {key}: the {what} already shards "
                f"the optimizer state with the weights")
        if not dist.is_initialized():
            raise RuntimeError(
                f"{key}={k} (ROADMAP P9b item {item}) needs a "
                f"torch.distributed group of a multiple of {k} processes: "
                f"call nps_tpu_torch.parallel.init_distributed first (the "
                f"CLI's --trainer.distributed)")
    if getattr(config, "zero1", False) and not dp:
        raise ValueError(
            "zero1=true shards the optimizer state over the data-parallel "
            "world: enable trainer.data_parallel")
    n = world_size()
    if n > 1 and not dp:
        raise ValueError(
            f"training in a world of {n} processes requires "
            f"trainer.data_parallel=true: without it each process would "
            f"train its own divergent model on a disjoint data shard")
    if n > 1 and not dist.is_initialized():
        raise RuntimeError(
            f"a world of {n} processes (WORLD_SIZE) with no torch.distributed "
            f"group: call nps_tpu_torch.parallel.init_distributed first (the "
            f"CLI's --trainer.distributed)")


def in_compute_dtype(method):
    """Run a trainer method inside the trainer's compute-dtype scope."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with compute_dtype_scope(self.compute_dtype):
            return method(self, *args, **kwargs)
    return run


def _cpu(obj):
    """``obj`` with every tensor in it on the CPU (dicts and lists)."""
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def _weighted_add(acc, v, bs):
    """Accumulate a batch metric weighted by batch size; recurses into
    nested dicts."""
    if isinstance(v, dict):
        acc = acc or {}
        return {k: _weighted_add(acc.get(k), vv, bs) for k, vv in v.items()}
    v = util.to_float(v) * bs
    return v if acc is None else acc + v


def _weighted_div(v, n):
    if isinstance(v, dict):
        return {k: _weighted_div(vv, n) for k, vv in v.items()}
    return v / n


class TrainInterface(metaclass=ABCMeta):
    def __init__(self, model, data, criterion, optimizer=None,
                 lr_scheduler=None, config=None, save_path="models/model",
                 max_train_batches=float("inf"), max_test_batches=float("inf"),
                 epoch_callback=None, use_wandb=False, wandb_kwargs=None,
                 wandb_config_dict=None, device="cuda", **kwargs):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.data = data
        self.config = config if config is not None else Namespace(**kwargs)
        self.config.save_path = save_path
        if not hasattr(self.config, "variable_time"):
            self.config.variable_time = \
                self.data.data_interface == D.sim1d_var_t
        refuse_unported(self.config)
        # the data-parallel world: this process's rank and the world's size
        # (rank 0 of 1 without data parallelism or a process group); under
        # spatial parallelism rank and world are the data slice's index and
        # the data extent, and ``grid`` holds the x group
        self.data_parallel = (bool(getattr(self.config, "data_parallel",
                                           False)) and dist.is_initialized())
        self.process_rank, self.process_count = (
            parallel.world() if self.data_parallel else (0, 1))
        self.rank, self.world = self.process_rank, self.process_count
        self.grid = self._regime = self._specs = None
        regime = grid_axis(self.config) if self.data_parallel else None
        if regime is not None:
            self._set_up_grid(*regime)
        self.compute_dtype = resolve_compute_dtype(
            getattr(self.config, "compute_dtype", None))

        self.criterion = criterion
        self.optimizer_spec = optimizer  # config dict or (optimizer, lr)
        self.lr_scheduler_spec = lr_scheduler
        self.max_train_batches = max_train_batches
        self.max_test_batches = max_test_batches
        self.epoch_callback = epoch_callback
        self.print_setting = dict(getattr(self.config, "print_setting",
                                          dict(print_per_step=False)))
        self.use_wandb = use_wandb and wandb is not None
        if use_wandb and wandb is None:
            warnings.warn("Could not import WandB -- WandB not used!")
        self.wandb_kwargs = wandb_kwargs
        self.wandb_config_dict = wandb_config_dict
        self.test_kwargs_list = getattr(self.config, "test_kwargs_list",
                                        [("default", {})])

        self.preempted = False
        self._preempt_requested = False
        self._last_epoch_partial = False
        self.initialized = False
        self.optimizer = None
        self.base_lr = None
        self.lr_scheduler = None
        self.start_epoch = 0

    def _set_up_grid(self, name, k):
        """The (data, ``name``) grid of K through the regime's hooks
        (:data:`_REGIME_MODULES`): the model and config checked (what the
        regime cannot take raises), the grid's groups, the data slice as
        this trainer's rank and world, and under tensor and expert
        parallelism this rank's share of the weights."""
        regime = self._regime = _REGIME_MODULES[name]
        regime.check(self.model, k, self.config)
        whole = spatial.whole(self.model) if name == "x" else None
        self.grid = parallel.Grid(k, name, whole=whole)
        self.rank, self.world = self.grid.data_index, self.grid.data_size
        if whole:
            # said out loud: such a model is not row-split, each x rank
            # computes the whole field
            print(f"spatial_parallel={k}: {whole} runs whole on each x rank "
                  f"(no row axis to split); its gradients are summed over "
                  f"the data group")
        self._whole_shapes = {key: t.shape for key, t in
                              self.model.state_dict().items()}
        self._specs = regime.setup(self.model, self.grid.axis, self.config)
        if self._specs is not None:
            self._load_whole(self.model.state_dict())

    def model_scope(self, x):
        """The model applies' ``parallel.scope``: this rank's grid axis (on
        the x axis at the grid of the global batch's fields, ``x`` the
        position grid [b, local rows, Y, d]), or none (no grid, or a model
        that runs whole on each x rank)."""
        g = self.grid
        if g is None or g.whole:
            return parallel.scope(None)
        if g.split:
            return parallel.scope(g.axis.at(x.shape[1] * g.axis.size))
        return parallel.scope(g.axis)

    def _grad_sums(self, params):
        """Each parameter's tag, as the group its gradient is summed over
        (``parallel.GradSums``): everything over the world without a grid;
        on a grid the regime's ``partial_params`` (a part of the gradient
        on each axis rank: every parameter under a row split, the encoder and
        the stages under pipeline parallelism, the gates under expert
        parallelism) over the world, the rest (whole, or its own shard's,
        on each axis rank) over the data group."""
        g = self.grid
        if g is None:
            return parallel.GradSums.world(params)
        partial = {id(p) for p in self._regime.partial_params(self.model)}
        return parallel.GradSums([
            (g.data_group, g.data_size,
             [p for p in params if id(p) not in partial], False),
            (None, world_size(), [p for p in params if id(p) in partial],
             True)])

    def global_sum(self, x):
        """``x`` summed over the global batch (``parallel.global_sum``: over
        the world, or a grid's :meth:`~parallel.Grid.sum_group`)."""
        if self.grid is None:
            return parallel.global_sum(x)
        return parallel.global_sum(x, *self.grid.sum_group())

    # ------------------------------------------------------------------
    # the weights of a sharded model (tensor and expert parallelism)
    # ------------------------------------------------------------------
    def _load_whole(self, state):
        """Load a whole ``state_dict``: this rank's share of it under tensor
        and expert parallelism."""
        if self._specs is None:
            self.model.load_state_dict(state)
            return
        local = self._regime.shard_state(state, self.grid.axis, self._specs)
        with torch.no_grad():
            for key, p in self.model.named_parameters():
                p.data = local[key].to(p.device, p.dtype).clone()
        for key, b in self.model.named_buffers():
            b.copy_(local[key])

    def whole_state(self):
        """The model's whole ``state_dict`` (a collective under tensor and
        expert parallelism: every rank calls it; the split tensors gathered
        over the axis group, bit for bit)."""
        return self._gather(self.model.state_dict())

    def whole_grads(self):
        """{parameter name: its whole gradient} (zeros where it has none;
        a collective under tensor and expert parallelism, as
        :meth:`whole_state`)."""
        return self._gather({
            k: (torch.zeros_like(p) if p.grad is None else p.grad).detach()
            for k, p in self.model.named_parameters()})

    def _gather(self, state):
        """The whole tensors of ``state`` ({parameter or buffer name: this
        rank's share}) from every axis rank's share, through the regime's
        ``merge`` (a collective of the axis group under tensor and expert
        parallelism, on the host), each on its share's device."""
        if self._specs is None:
            return state
        shares = self._axis_shares(state)
        return {key: self._regime.merge([s[key] for s in shares],
                                        self._specs.get(key)).to(t.device)
                for key, t in state.items()}

    def _axis_shares(self, obj):
        """Every axis rank's ``obj`` (on the host), in rank order."""
        shares = [None] * self.grid.axis.size
        dist.all_gather_object(shares, _cpu(obj), group=self.grid.axis.group)
        return shares

    def __repr__(self):
        return self.__class__.__name__

    @property
    @abstractmethod
    def model_interface(self):
        raise NotImplementedError("model_interface not set!")

    @property
    @abstractmethod
    def data_interface(self):
        raise NotImplementedError("data_interface not set!")

    # ------------------------------------------------------------------
    # parameters, optimizer, scheduler
    # ------------------------------------------------------------------
    def init_params(self, seed=None):
        """Draw torch-default weights from ``torch.Generator(seed)`` (the
        config's seed by default), on the host, so a seed gives the same
        weights on any device."""
        seed = get_seed() if seed is None else seed
        if self._specs is not None:
            # the whole weights, drawn as one process draws them
            with torch.no_grad():
                for key, p in self.model.named_parameters():
                    p.data = p.new_empty(self._whole_shapes[key])
        reset_parameters(self.model, torch.Generator().manual_seed(seed))
        if self._specs is not None:
            parallel.replicate(self.model)
            self._load_whole(self.model.state_dict())
        else:
            self._replicate()
        self.initialized = True

    def _replicate(self):
        """Data parallelism: every rank takes rank 0's parameters and
        buffers (a collective: every rank calls it); under tensor and
        expert parallelism every data slice takes data slice 0's shard."""
        if not self.data_parallel:
            return
        if self._specs is not None:
            self.grid.broadcast_in_data([*self.model.parameters(),
                                         *self.model.buffers()])
        else:
            parallel.replicate(self.model)

    def load_jax_params(self, tree):
        """Load an ``nps_tpu`` parameter tree (nested dicts of arrays)."""
        self._load_whole(from_jax_params(tree))
        self._replicate()
        self.initialized = True
        return self

    def ensure_initialized(self):
        """Draw the weights unless loaded, and build the optimizer once its
        spec is set."""
        if not self.initialized:
            self.init_params()
        if self.optimizer is None and self.optimizer_spec is not None:
            self._build_optimizer()

    def set_optimizer(self, optimizer):
        self.optimizer_spec = optimizer
        if self.initialized:
            self._build_optimizer()

    def set_lr_scheduler(self, lr_scheduler):
        self.lr_scheduler_spec = lr_scheduler
        self._build_lr_scheduler()

    def _build_optimizer(self):
        if self.optimizer_spec is None:
            return
        spec = self.optimizer_spec
        zero1 = self.data_parallel and getattr(self.config, "zero1", False)
        if zero1 and not isinstance(spec, dict):
            raise ValueError("zero1 builds its optimizer over this rank's "
                             "share of the parameters: give the optimizer "
                             "as a config dict")
        params = list(self.model.parameters())
        if zero1:
            cls, kw = optim_lib.optimizer_class(**spec)
            self.optimizer = parallel.Zero1(params, cls,
                                            sums=self._grad_sums(params),
                                            **kw)
            self.base_lr = float(kw["lr"])
        elif isinstance(spec, dict):
            self.optimizer, self.base_lr = optim_lib.build_optimizer(
                params, **spec)
        else:
            self.optimizer, self.base_lr = spec
        if self.data_parallel and not zero1:
            self.optimizer = parallel.AllReduceGrads(
                self.optimizer, self._grad_sums(params))
        accum = int(getattr(self.config, "grad_accum", 0) or 0)
        if accum > 1:
            self.optimizer = optim_lib.MultiSteps(self.optimizer, accum)
        self._build_lr_scheduler()

    def _build_lr_scheduler(self):
        spec = self.lr_scheduler_spec
        if self.optimizer is None:
            return
        if spec is None:
            self.lr_scheduler = optim_lib.ConstantLR(self.base_lr)
        elif isinstance(spec, dict):
            self.lr_scheduler = optim_lib.build_lr_scheduler(self.base_lr,
                                                             **spec)
        else:
            self.lr_scheduler = spec

    # ------------------------------------------------------------------
    # data loading
    # ------------------------------------------------------------------
    def get_dataloaders(self):
        """(train, valid, test) loaders. ``eval_batch_size`` (0: the train
        batch size) sizes the evaluation loaders; ``device_cache`` keeps the
        splits on the device (``device_cache_scope="train"``: the train split
        only; ``device_cache_dtype``: cast the cached floats). Variable-time
        data takes :meth:`_variable_time_loaders`. Under data parallelism
        each loader yields this rank's slice of every global batch of
        ``batch_size``."""
        if self.config.variable_time:
            return self._variable_time_loaders()
        kw = dict(batch_size=self.config.batch_size, shuffle=True,
                  seed=get_seed(), **self._fleet())
        ekw = dict(kw, batch_size=int(
            getattr(self.config, "eval_batch_size", 0)
            or self.config.batch_size))
        splits = (self.data.train, self.data.valid, self.data.test)
        if not getattr(self.config, "device_cache", False):
            return tuple(HostDataLoader(s, **k)
                         for s, k in zip(splits, (kw, ekw, ekw)))
        scope = str(getattr(self.config, "device_cache_scope", None)
                    or "all").lower()
        train = DeviceCacheLoader(
            splits[0], device=self.device,
            cache_dtype=getattr(self.config, "device_cache_dtype", None),
            **kw)
        if scope == "train":
            return (train, HostDataLoader(splits[1], **ekw),
                    HostDataLoader(splits[2], **ekw))
        return (train,
                DeviceCacheLoader(splits[1], device=self.device, **ekw),
                DeviceCacheLoader(splits[2], device=self.device, **ekw))

    def _fleet(self):
        """The loaders' share of the world: this rank's slice of global
        batches trimmed to a multiple of the world's size (under spatial
        parallelism the data slice's, of the data extent)."""
        return dict(process_index=self.rank, process_count=self.world)

    def _variable_time_loaders(self):
        """(train, valid, test) for ``D.sim1d_var_t``, as the JAX trainer
        builds them: a :class:`VariableTimeBatchSampler` per
        split (the config's ``sampler``: ``time_window`` and
        ``max_unrolling`` default to the trainer's, ``with_replacement`` to
        True for training; evaluation draws without replacement), the train
        loader min-crops and the evaluation loaders max-pad."""
        sampler_cfg = dict(getattr(self.config, "sampler", None) or {})
        sampler_cfg.pop("object", None)
        sampler_cfg.setdefault("time_window", self.config.time_window)
        sampler_cfg.setdefault("max_unrolling",
                               getattr(self.config, "unrolling", 0))
        with_repl = sampler_cfg.pop("with_replacement", True)
        bs = self.config.batch_size
        ebs = int(getattr(self.config, "eval_batch_size", 0) or bs)
        if bs % self.world:
            raise ValueError(
                f"batch_size={bs} must divide by the data-parallel world's "
                f"{self.world} processes for variable-time training")

        def loader(split, mode, with_replacement, batch_size):
            sampler = VariableTimeBatchSampler(
                split, batch_size=batch_size,
                with_replacement=with_replacement, seed=get_seed(),
                **sampler_cfg)
            return VariableTimeLoader(split, sampler, mode=mode,
                                      time_window=self.config.time_window,
                                      seed=get_seed(), **self._fleet())

        return (loader(self.data.train, "min", with_repl, bs),
                loader(self.data.valid, "max", False, ebs),
                loader(self.data.test, "max", False, ebs))

    def _batches(self, loader):
        """The loader's batches on the device; under spatial parallelism
        this rank's rows of each (cut on the host before the copy), where
        the model splits over the rows."""
        batches = iter(loader)
        if self.grid is not None and self.grid.split:
            batches = map(self.grid.shard_batch, batches)
        if getattr(loader, "device_resident", False):
            return batches
        return prefetch_to_device(batches, self.device)

    # ------------------------------------------------------------------
    # the step contract
    # ------------------------------------------------------------------
    def train_step(self, batch, epoch, batch_idx, loader):
        """Consume one device batch, update the parameters, return
        (loss, preds_or_None)."""
        raise NotImplementedError("The method train_step should be implemented!")

    def test_step(self, batch, batch_idx, use_train_loss_calc=False,
                  include_data=False, **kwargs):
        if include_data:
            raise ValueError(
                "include_data is only supported when implemented in test_step")
        if not use_train_loss_calc:
            raise NotImplementedError("The test_step method is not implemented!")
        loss, _ = self.train_step(batch, epoch=0, batch_idx=batch_idx,
                                  loader=None)
        return loss, {}

    def simulate(self, u, *args, **kwargs):
        raise NotImplementedError("The method simulate is not implemented!")

    def __call__(self):
        self.train()

    # ------------------------------------------------------------------
    # training loop
    # ------------------------------------------------------------------
    def train(self):
        assert self.model.model_interface in self.model_interface, \
            f"{self} does not support model {self.model}."
        assert self.data.data_interface in self.model.data_interface, \
            f"{self.model} does not support data from {self.data}."
        assert self.data.data_interface in self.data_interface, \
            f"{self} does not support data from {self.data}."

        train_loader, valid_loader, test_loader = self.get_dataloaders()
        self.ensure_initialized()
        if self.maybe_resume(train_loader=train_loader):
            print(f"Resumed from checkpoint at epoch {self.start_epoch}")
        self._install_preempt_handlers()
        if self.use_wandb:
            wandb.init(config=self.wandb_config_dict, **(self.wandb_kwargs or {}))
        with autotuned_convs():
            return self._train_epochs(train_loader, valid_loader, test_loader)

    def _train_epochs(self, train_loader, valid_loader, test_loader):
        fall_back = False
        train_losses = []
        min_val_loss = {name: float("inf") for name, _ in self.test_kwargs_list}
        # best-model tracking continues across a resume
        for name, v in getattr(self, "_resumed_min_val_loss", {}).items():
            if name in min_val_loss:
                min_val_loss[name] = v
        val_losses = {name: [] for name, _ in self.test_kwargs_list}
        val_stats_list = {name: [] for name, _ in self.test_kwargs_list}
        time_start = time.perf_counter()
        samples_seen = 0

        for epoch in range(self.start_epoch, self.config.num_epochs):
            train_loss, n_samples = self.train_one_epoch(train_loader, epoch)
            if self._last_epoch_partial or self._preempt_fleet_agreed():
                # a partial epoch's loss is dropped and the checkpoint points
                # at `epoch`; a signal caught after the epoch's last batch
                # keeps the epoch and resumes at epoch + 1
                partial = self._last_epoch_partial
                if not partial:
                    train_losses.append(train_loss)
                return self._preempt_exit(epoch + (0 if partial else 1),
                                          min_val_loss, train_loader,
                                          train_losses, val_losses,
                                          val_stats_list)
            samples_seen += n_samples
            train_losses.append(train_loss)

            if (epoch + 1) % self.config.print_interval == 0:
                dt_total = time.perf_counter() - time_start
                if (epoch + 1) % self.config.test_interval == 0:
                    progress = 1.0
                else:
                    nxt = epoch + 1
                    prev_test = nxt - nxt % self.config.test_interval
                    progress = (epoch + 1 - prev_test) / self.config.test_interval
                sps = samples_seen / max(dt_total, 1e-9)
                print(f"Epoch {epoch} (progress: {progress:.2f}, "
                      f"{dt_total:.4f}s, {sps:.1f} samples/s), "
                      f"Loss {util.to_float(train_loss)}")
                time_start = time.perf_counter()
                samples_seen = 0

            epoch_log = {"train_loss": util.to_float(train_loss)}
            if (epoch + 1) % self.config.test_interval == 0:
                for name, test_kwargs in self.test_kwargs_list:
                    print(f"Evaluation on validation dataset for setting "
                          f"[{name}]:")
                    if callable(test_kwargs):
                        val_loss, val_stats = test_kwargs(valid_loader, self)
                    else:
                        try:
                            val_loss, val_stats = self.test(
                                valid_loader, fall_back,
                                test_kwargs=test_kwargs)
                        except NotImplementedError:
                            warnings.warn(
                                "test_step not implemented; falling back to "
                                "training loss for validation!")
                            fall_back = True
                            val_loss, val_stats = self.test(
                                valid_loader, fall_back,
                                test_kwargs=test_kwargs)
                    val_loss = util.to_float(val_loss)
                    print(f"Evaluation metric: {val_loss}")
                    if not self.print_setting.get("print_per_step", False):
                        val_stats = {k: v for k, v in val_stats.items()
                                     if "step" not in k.lower()}
                    stats_f = util.to_floatdict(val_stats)
                    print(util.dict_str(stats_f, prefix="-"))
                    print()

                    epoch_log[name + " - val loss"] = val_loss
                    for k, v in stats_f.items():
                        epoch_log[name + "-" + str(k)] = v

                    val_losses[name].append(val_loss)
                    val_stats_list[name].append(val_stats)
                    if val_loss < min_val_loss[name]:
                        self.save_model(self.config.save_path + f"_{name}")
                        min_val_loss[name] = val_loss
                        print("Found new best model, evaluation on test "
                              "dataset:")
                        if callable(test_kwargs):
                            test_loss, test_stats = test_kwargs(test_loader,
                                                                self)
                        else:
                            test_loss, test_stats = self.test(
                                test_loader, fall_back, test_kwargs=test_kwargs)
                        print(f"Test metric: {util.to_float(test_loss)}")
                        if not self.print_setting.get("print_per_step", False):
                            test_stats = {k: v for k, v in test_stats.items()
                                          if "step" not in k.lower()}
                        print(util.dict_str(util.to_floatdict(test_stats),
                                            prefix="-"))
                        print()

            # on its own schedule, not nested in the test_interval block:
            # None -> test_interval, 0 disables
            ckpt_every = getattr(self.config, "checkpoint_interval", None)
            ckpt_every = (self.config.test_interval if ckpt_every is None
                          else int(ckpt_every))
            if ckpt_every and (epoch + 1) % ckpt_every == 0:
                self.save_checkpoint(epoch + 1, min_val_loss,
                                     train_loader=train_loader)

            self._log_metrics_jsonl(epoch, epoch_log)
            if self.use_wandb:
                wandb.log(epoch_log)
            if self._preempt_fleet_agreed():
                # caught during validation or checkpointing: the epoch is
                # complete, so the resumed run continues at epoch + 1
                return self._preempt_exit(epoch + 1, min_val_loss,
                                          train_loader, train_losses,
                                          val_losses, val_stats_list)

        self._restore_preempt_handlers()
        self.save_model(self.config.save_path + "_final")
        if self.use_wandb:
            wandb.finish()
        return train_losses, val_losses, val_stats_list

    def train_one_epoch(self, loader, epoch):
        total_loss = torch.zeros((), device=self.device)
        n_samples = 0
        self._last_epoch_partial = False
        for batch_idx, batch in enumerate(self._batches(loader)):
            if self._preempt_fleet_agreed():
                # stop at the batch boundary; train() checkpoints and exits
                self._last_epoch_partial = True
                return float(total_loss), n_samples
            loss, _ = self.train_step(batch, epoch, batch_idx, loader=loader)
            bs = self._batch_size(batch)
            total_loss = total_loss + loss / bs
            n_samples += bs
            if batch_idx >= self.max_train_batches:
                break
        # as the reference: the break is inclusive of batch_idx ==
        # max_train_batches, and the denominator stays len(loader)
        total_loss = total_loss / len(loader)

        if self.epoch_callback is not None:
            self.epoch_callback(self, loader, epoch)

        if self.lr_scheduler is not None and self.optimizer is not None:
            if (epoch + 1) % self.config.lr_step_interval == 0:
                self.lr_scheduler.step()
                optim_lib.set_learning_rate(self.optimizer,
                                            self.lr_scheduler.lr)
        return float(total_loss), n_samples

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def test(self, loader, use_train_loss_calc=False, include_data=False,
             test_kwargs=None):
        test_kwargs = test_kwargs or {}
        self.ensure_initialized()
        loss = 0.0
        other_metrics = {}
        n_total = 0
        data_gt, data_pred, data_other = [], [], []
        with autotuned_convs():
            for batch_idx, batch in enumerate(self._batches(loader)):
                out = self.test_step(batch, batch_idx, use_train_loss_calc,
                                     include_data, **test_kwargs)
                if include_data:
                    batch_loss, batch_metrics, batch_data = out
                else:
                    batch_loss, batch_metrics = out
                bs = self._batch_size(batch)
                loss = loss + util.to_float(batch_loss) * bs
                n_total += bs
                for k, v in batch_metrics.items():
                    other_metrics[k] = _weighted_add(other_metrics.get(k), v,
                                                     bs)
                if include_data:
                    data_gt.append(np.asarray(batch_data[0]))
                    data_pred.append(np.asarray(batch_data[1]))
                    data_other.extend(batch_data[2])
                if batch_idx >= self.max_test_batches - 1:
                    break
        loss = loss / n_total
        other_metrics = {k: _weighted_div(v, n_total)
                         for k, v in other_metrics.items()}
        if include_data:
            data_gt = np.concatenate(data_gt, axis=0)
            data_pred = np.concatenate(data_pred, axis=0)
            return loss, other_metrics, (np.stack([data_gt, data_pred]),
                                         data_other)
        return loss, other_metrics

    def _batch_size(self, batch):
        """The global batch's size: this rank's times the world's (every
        rank holds an equal slice)."""
        return util.get_batch_size(batch) * self.world

    def _is_writer_process(self):
        """Only rank 0 writes checkpoints, exports and metrics (the ranks'
        writes to a shared filesystem would race)."""
        return self.process_rank == 0

    def _log_metrics_jsonl(self, epoch, epoch_log):
        """Append one JSON line per epoch to ``<save_path>_metrics.jsonl``,
        a training-curve record a hard kill cannot lose; a resumed run keeps
        appending. Opt-out: ``trainer.metrics_jsonl=False``."""
        if not getattr(self.config, "metrics_jsonl", True) \
                or not self._is_writer_process():
            return
        path = self.config.save_path + "_metrics.jsonl"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps({"epoch": epoch, **epoch_log}, default=float)
                    + "\n")

    # ------------------------------------------------------------------
    # preemption: SIGTERM/SIGINT -> checkpoint at a batch boundary -> exit
    # ------------------------------------------------------------------
    def _install_preempt_handlers(self):
        """SIGTERM/SIGINT sets a flag; the epoch loop stops at the next batch
        boundary, saves a full checkpoint and returns with ``self.preempted``
        set. A second signal raises KeyboardInterrupt. Opt-out:
        ``trainer.preempt_checkpoint=False``. No-op off the main thread."""
        self._orig_handlers = {}
        if not getattr(self.config, "preempt_checkpoint", True):
            return
        self.preempted = False
        self._preempt_requested = False
        self._last_epoch_partial = False

        def handler(signum, frame):
            if self._preempt_requested:
                self._restore_preempt_handlers()
                raise KeyboardInterrupt
            print(f"[nps_tpu_torch] caught signal {signum}: checkpointing at "
                  f"the next batch boundary, then exiting (signal again to "
                  f"abort immediately)")
            self._preempt_requested = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._orig_handlers[sig] = signal.signal(sig, handler)
            except ValueError:  # not the main thread
                self._orig_handlers = {}
                return

    def _restore_preempt_handlers(self):
        for sig, h in getattr(self, "_orig_handlers", {}).items():
            signal.signal(sig, h)
        self._orig_handlers = {}

    def _preempt_fleet_agreed(self):
        """Whether any rank caught a stop signal: under data parallelism an
        all-reduce (max) of the flags, which every rank makes at every batch
        boundary, so all stop at the same one (a rank that went on alone
        would wait in its next step's collectives forever); the local flag
        in one process. The answer is the all-reduce's, never the local
        flag read after it: a signal caught between the two is the next
        boundary's, on every rank."""
        if not self.data_parallel:
            return self._preempt_requested
        flag = torch.tensor([float(self._preempt_requested)],
                            device=self.device)
        parallel.all_reduce_([flag], op=dist.ReduceOp.MAX)
        agreed = bool(flag.item())
        if agreed:
            self._preempt_requested = True
        return agreed

    def _preempt_exit(self, epoch, min_val_loss, train_loader,
                      train_losses, val_losses, val_stats_list):
        self.save_checkpoint(epoch, min_val_loss, train_loader=train_loader)
        self.preempted = True
        self._restore_preempt_handlers()
        print(f"Preempted at epoch {epoch}: checkpoint saved — rerun with "
              f"trainer.resume=True to continue")
        if self.use_wandb:
            wandb.finish()
        return train_losses, val_losses, val_stats_list

    # ------------------------------------------------------------------
    # model export, checkpoint and resume
    # ------------------------------------------------------------------
    def save_model(self, save_name):
        """Write the model's ``state_dict`` (CPU tensors) to
        ``save_name`` (``.pt`` unless it has an extension)."""
        state = self.whole_state()
        if not self._is_writer_process():
            return
        root, ext = os.path.splitext(save_name)
        save_name = root + (ext or ".pt")
        os.makedirs(os.path.dirname(save_name) or ".", exist_ok=True)
        torch.save({k: v.detach().cpu() for k, v in state.items()},
                   save_name)
        print(f"Saved model at {save_name}")

    def load_model(self, save_name):
        state = torch.load(save_name, map_location="cpu", weights_only=True)
        self._load_whole(state)
        self._replicate()
        self.initialized = True

    def _ckpt_path(self):
        return self.config.save_path + "_checkpoint.pt"

    def _rng_states(self):
        """Hook: the subclass's own generators, saved with a checkpoint."""
        return {}

    def _set_rng_states(self, states):
        """Hook: restore what :meth:`_rng_states` saved."""

    def save_checkpoint(self, epoch, min_val_loss=None, train_loader=None):
        """The full training state: model, optimizer, epoch, scheduler
        counter, best validation losses and every generator, so a resumed
        run continues the same sequence of batches and draws. Under data
        parallelism every rank calls it (ZeRO-1's state is gathered on
        rank 0) and rank 0 writes it; the generators are the same on
        every rank."""
        optimizer = self._optimizer_state()
        model = self.whole_state()
        if not self._is_writer_process():
            return
        state = dict(
            epoch=epoch,
            model={k: v.detach().cpu() for k, v in model.items()},
            optimizer=optimizer,
            lr_epoch=getattr(self.lr_scheduler, "epoch", 0),
            min_val_loss=min_val_loss or {},
            np_random=np.random.get_state(),
            py_random=py_random.getstate(),
            torch_random=torch.get_rng_state(),
            rng=self._rng_states(),
        )
        rng = getattr(train_loader, "_rng", None)
        if rng is not None:
            state["loader_rng"] = rng.bit_generator.state
        path = self._ckpt_path()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        print(f"Saved checkpoint at {path} (epoch {epoch})")

    def _optimizer_state(self):
        """The optimizer's state for a checkpoint (a collective). Under
        tensor and expert parallelism each parameter's state (Adam's
        moments, an accumulated gradient) is gathered whole, as the weights
        are, so that one process or any grid resumes it."""
        if self.optimizer is None:
            return None
        state = self.optimizer.state_dict()
        if self._specs is None:
            return state
        names = [name for name, _ in self.model.named_parameters()]
        return self._map_param_state(
            self._axis_shares(state),
            lambda i, values: self._regime.merge(values,
                                                 self._specs.get(names[i])))

    def _shard_optimizer_state(self, state):
        """This rank's share of a whole optimizer state (each tensor shaped
        as its whole parameter split as the parameter is); the state of a
        parameter this rank holds nothing of is dropped."""
        if self._specs is None or state is None:
            return state
        axis, shapes = self.grid.axis, self._whole_shapes
        names, held = zip(*((name, p.numel() > 0) for name, p
                            in self.model.named_parameters()))

        def share(i, values):
            name, v = names[i], values[0]
            if not held[i] or v is None:
                return None
            if v.shape != shapes[name]:   # a step count
                return v
            return self._regime.shard_state({name: v}, axis,
                                            self._specs)[name]

        return self._map_param_state([state], share)

    @staticmethod
    def _map_param_state(states, fn):
        """One optimizer ``state_dict`` from ``states`` (several of the same
        optimizer's, the first's structure kept: a torch optimizer's, or a
        ``MultiSteps``' around one) with each per-parameter tensor
        ``fn(index, [its value in each state, or None])``; an entry whose
        tensors all map to None is left out."""
        first = states[0]
        if "inner" in first:
            acc = [fn(i, [s["acc_grads"][i] for s in states])
                   if any(s["acc_grads"][i] is not None for s in states)
                   else None for i in range(len(first["acc_grads"]))]
            return dict(first, acc_grads=acc, inner=TrainInterface.
                        _map_param_state([s["inner"] for s in states], fn))
        out = {}
        for i in sorted({i for s in states for i in s["state"]}):
            entries = [s["state"].get(i) for s in states]
            fields = next(e for e in entries if e is not None)
            entry = {f: fn(i, [None if e is None else e[f] for e in entries])
                     for f in fields}
            if any(v is not None for v in entry.values()):
                out[i] = entry
        return dict(first, state=out)

    def maybe_resume(self, train_loader=None):
        if not getattr(self.config, "resume", False):
            return False
        path = self._ckpt_path()
        found = os.path.exists(path)
        if self.data_parallel:
            # every rank reads rank 0's checkpoint: all must find it
            seen = torch.tensor([float(found), float(not found)],
                                device=self.device)
            parallel.all_reduce_([seen])
            if seen.min() > 0:
                raise RuntimeError(
                    f"{int(seen[0])} of {self.process_count} ranks found the "
                    f"checkpoint {path}: a data-parallel resume reads rank "
                    f"0's checkpoint from a path every rank sees")
        if not found:
            return False
        # this program's own file: it holds numpy and python RNG states,
        # which the weights-only loader refuses
        state = torch.load(path, map_location="cpu", weights_only=False)
        self._load_whole(state["model"])
        self.initialized = True
        optimizer = self._shard_optimizer_state(state["optimizer"])
        if self.optimizer is not None and optimizer is not None:
            self.optimizer.load_state_dict(optimizer)
        self.start_epoch = state["epoch"]
        self._resumed_min_val_loss = dict(state.get("min_val_loss", {}))
        if train_loader is not None and "loader_rng" in state \
                and getattr(train_loader, "_rng", None) is not None:
            train_loader._rng.bit_generator.state = state["loader_rng"]
        if hasattr(self.lr_scheduler, "epoch"):
            self.lr_scheduler.epoch = state["lr_epoch"]
            optim_lib.set_learning_rate(self.optimizer, self.lr_scheduler.lr)
        np.random.set_state(state["np_random"])
        py_random.setstate(state["py_random"])
        torch.set_rng_state(state["torch_random"])
        self._set_rng_states(state["rng"])
        return True
