"""Optimizer / LR-scheduler registry (counterpart of
``nps_tpu/train/optim.py``).

``build_optimizer`` maps the config's dotted names onto ``torch.optim``
with the JAX package's defaults (betas (0.9, 0.999), eps 1e-8). optax's
``adam`` with a weight decay is its decoupled ``adamw``, so that case maps
to ``AdamW``, as ``optim.AdamW`` does (default decay 0.01). The schedulers
are the same host-side classes: MultiStepLR multiplies the learning rate by
``gamma`` each time its step counter crosses a milestone, and the trainer
steps it every ``lr_step_interval`` epochs and writes the rate into the
optimizer with :func:`set_learning_rate`.

:class:`MultiSteps` is ``optax.MultiSteps``, the JAX trainer's gradient
accumulation (``trainer.grad_accum``): the gradients of N mini-steps are
averaged and the wrapped optimizer steps once, at the N-th. Under data
parallelism it wraps the data-parallel optimizer
(``parallel.AllReduceGrads`` or ``parallel.Zero1``), whose step sums the
gradients over the world: the mini-steps that apply no update sync
nothing, and the boundary syncs once.
"""

import numpy as np
import torch


def optimizer_class(object="optim.Adam", lr=1e-3, **kwargs):
    """-> (torch optimizer class, its keyword arguments) of a config's
    optimizer spec."""
    name = object.split(".")[-1].lower()
    kw = dict(kwargs)
    betas = tuple(kw.pop("betas", (0.9, 0.999)))
    eps = kw.pop("eps", 1e-8)
    weight_decay = kw.pop("weight_decay", 0.0)
    if name == "adam":
        if weight_decay:
            return torch.optim.AdamW, dict(lr=lr, betas=betas, eps=eps,
                                           weight_decay=weight_decay)
        return torch.optim.Adam, dict(lr=lr, betas=betas, eps=eps)
    if name == "adamw":
        return torch.optim.AdamW, dict(lr=lr, betas=betas, eps=eps,
                                       weight_decay=weight_decay or 0.01)
    if name == "sgd":
        return torch.optim.SGD, dict(lr=lr, momentum=kw.pop("momentum", 0.0))
    raise ValueError(f"Unknown optimizer '{object}'")


def build_optimizer(params, **spec):
    """-> (torch optimizer over ``params``, base learning rate)."""
    cls, kw = optimizer_class(**spec)
    return cls(params, **kw), float(kw["lr"])


class MultiStepLR:
    """Torch MultiStepLR replica operating on a host-side lr value."""

    def __init__(self, base_lr, milestones, gamma=0.1):
        self.base_lr = float(base_lr)
        self.milestones = sorted(int(m) for m in milestones)
        self.gamma = float(gamma)
        self.epoch = 0  # scheduler step counter (not training epochs)

    def step(self):
        self.epoch += 1

    @property
    def lr(self):
        n = int(np.searchsorted(self.milestones, self.epoch, side="right"))
        return self.base_lr * (self.gamma ** n)


class StepLR:
    def __init__(self, base_lr, step_size, gamma=0.1):
        self.base_lr = float(base_lr)
        self.step_size = int(step_size)
        self.gamma = float(gamma)
        self.epoch = 0

    def step(self):
        self.epoch += 1

    @property
    def lr(self):
        return self.base_lr * (self.gamma ** (self.epoch // self.step_size))


class ConstantLR:
    def __init__(self, base_lr):
        self.base_lr = float(base_lr)

    def step(self):
        pass

    @property
    def lr(self):
        return self.base_lr


def build_lr_scheduler(base_lr, object=None, **kwargs):
    if object is None:
        return ConstantLR(base_lr)
    name = object.split(".")[-1] if isinstance(object, str) else object
    if name == "MultiStepLR":
        return MultiStepLR(base_lr, kwargs["milestones"],
                           kwargs.get("gamma", 0.1))
    if name == "StepLR":
        return StepLR(base_lr, kwargs["step_size"], kwargs.get("gamma", 0.1))
    raise ValueError(f"Unknown lr scheduler '{object}'")


class MultiSteps:
    """Gradient accumulation over ``every`` mini-steps, as
    ``optax.MultiSteps(tx, every_k_schedule=every)``: ``zero_grad`` clears
    the gradients only where a window starts, so each mini-step's backward
    adds its gradients into the f32 ``.grad``; ``step`` counts the
    mini-step and, at the ``every``-th, scales the sum by 1/``every`` (optax
    keeps a running mean: the same value up to rounding) and steps the
    wrapped optimizer once. Between boundaries the parameters and the
    wrapped optimizer's state (Adam's moments and step count) do not
    change. The parameter groups are the wrapped optimizer's, so
    :func:`set_learning_rate` reaches the optimizer that steps. The partial
    sum and its counter belong to the state: :meth:`state_dict` holds them,
    so they carry over an epoch's end and through a checkpoint.

    Under data parallelism (an inner optimizer with ``sums``) each rank's
    partial sum is its own until the boundary: :meth:`state_dict` sums them,
    each over its parameter's group (every rank calls it), and
    :meth:`load_state_dict` gives each rank 1/n of that sum (n the group's
    ranks), which the boundary's all-reduce adds up to the same total."""

    def __init__(self, optimizer, every):
        if int(every) < 2:
            raise ValueError(f"MultiSteps accumulates over every >= 2 "
                             f"mini-steps, got {every}")
        self.inner = optimizer
        self.every = int(every)
        self.mini_step = 0

    @property
    def param_groups(self):
        return self.inner.param_groups

    def _params(self):
        return [p for g in self.inner.param_groups for p in g["params"]]

    def zero_grad(self, set_to_none=True):
        if self.mini_step == 0:
            self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self):
        self.mini_step += 1
        if self.mini_step < self.every:
            return
        for p in self._params():
            if p.grad is not None:
                p.grad.div_(self.every)
        self.inner.step()
        self.mini_step = 0

    def _sums(self):
        return getattr(self.inner, "sums", None)

    def state_dict(self):
        params = self._params()
        acc = [None if p.grad is None or self.mini_step == 0
               else p.grad.detach().clone() for p in params]
        if self._sums() is not None:
            acc = self._sums().reduce_(params, acc)
        return {"inner": self.inner.state_dict(), "every": self.every,
                "mini_step": self.mini_step,
                "acc_grads": [None if g is None else g.cpu() for g in acc]}

    def load_state_dict(self, state):
        if int(state["every"]) != self.every:
            raise ValueError(f"checkpoint accumulates over {state['every']} "
                             f"mini-steps, this run over {self.every}")
        self.inner.load_state_dict(state["inner"])
        self.mini_step = int(state["mini_step"])
        sums = self._sums()
        for p, g in zip(self._params(), state["acc_grads"], strict=True):
            n = 1 if sums is None else sums.size_of(p)
            p.grad = None if g is None else g.to(p.device, p.dtype) / n


def set_learning_rate(optimizer, lr):
    """Write ``lr`` into every parameter group of ``optimizer`` (through a
    :class:`MultiSteps`, the wrapped optimizer's)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
