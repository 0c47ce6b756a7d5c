"""Activation objects usable as config values (counterpart of
``nps_tpu/models/activations.py``).

Config files carry activation instances (``GELU()``, ``Tanh()``); these are
plain callables on tensors, hashable and comparable, so the config parser can
copy and compare them, and they hold no parameters. ``GELU`` is the exact
erf form, torch's default and the reference's.
"""

import torch
import torch.nn.functional as F

from nps_tpu_torch.models.config import fast_forward_active


class _Activation:
    """Base: a named, argument-carrying callable usable as a config value."""

    def __call__(self, x):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self).__name__, tuple(sorted(self.__dict__.items()))))

    def __deepcopy__(self, memo):
        return self

    @classmethod
    def _parse_override(cls, spec):
        """CLI-override hook for the config parser
        (``--model.activation=gelu_tanh``)."""
        return resolve_activation(spec)


class GELU(_Activation):
    """Exact-erf GELU (torch's default ``nn.GELU()``); the tanh form inside
    a no-grad pushforward step under ``trainer.pushforward_fast``
    (:func:`~nps_tpu_torch.models.config.fast_forward_scope`)."""

    def __call__(self, x):
        return F.gelu(x, approximate=("tanh" if fast_forward_active()
                                      else "none"))


class GELUTanh(_Activation):
    """Tanh-approximate GELU."""

    def __call__(self, x):
        return F.gelu(x, approximate="tanh")


class Tanh(_Activation):
    def __call__(self, x):
        return torch.tanh(x)


class ReLU(_Activation):
    def __call__(self, x):
        return torch.relu(x)


class SiLU(_Activation):
    def __call__(self, x):
        return F.silu(x)


class Identity(_Activation):
    def __call__(self, x):
        return x


class Swish(_Activation):
    """x * sigmoid(beta * x)."""

    def __init__(self, beta=1):
        self.beta = beta

    def __call__(self, x):
        return x * torch.sigmoid(self.beta * x)


_BY_NAME = {
    "gelu": GELU(),
    "gelu_tanh": GELUTanh(),
    "gelu_approx": GELUTanh(),
    "tanh": Tanh(),
    "relu": ReLU(),
    "silu": SiLU(),
    "swish": Swish(),
    "identity": Identity(),
    "none": Identity(),
}


def resolve_activation(act):
    """Normalize an activation spec (None / str / activation object /
    callable) to a callable on tensors."""
    if act is None:
        return Identity()
    if isinstance(act, _Activation):
        return act
    if isinstance(act, str):
        key = act.lower()
        if key not in _BY_NAME:
            raise ValueError(f"Unknown activation '{act}'")
        return _BY_NAME[key]
    if callable(act):
        return act
    raise ValueError(f"Cannot resolve activation from {act!r}")


def fused_gelu(act):
    """The GELU form the fused GroupNorm kernel applies in place of ``act``:
    "none" (the exact erf form) for ``GELU``, "tanh" for ``GELUTanh``, as
    ``F.gelu``'s ``approximate`` spells them; None for any other
    activation."""
    act = resolve_activation(act)
    if isinstance(act, GELUTanh):
        return "tanh"
    return "none" if isinstance(act, GELU) else None
