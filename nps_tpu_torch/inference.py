"""Serving API (counterpart of ``nps_tpu/inference.py``): build a surrogate
from a training config, load weights, run autoregressive rollouts.

    from nps_tpu_torch.inference import SurrogateEngine
    eng = SurrogateEngine.from_config(
        "nps_tpu_torch/configs/train/cfg_twophase_ufno.py", pde=my_pde)
    eng.init_params(seed=0)                 # or eng.load("weights.pt")
    frames = eng.rollout(u0, n_steps=19, cond=cond, spatial_cond=sc)

The engine runs on ``device`` ("cuda" unless the caller asks for "cpu"); on
the GPU the model goes through the hand-written kernels. The rollout is a
Python loop of model applications under ``torch.inference_mode()``, with
cuDNN choosing each convolution's algorithm by timing (see
:func:`autotuned_convs`) and the spectral weights packed once per call of
``step`` or ``rollout``. Inputs
and outputs are numpy arrays in the JAX package's layout: ``u`` is
``[b, c, tw, *sp]``, ``cond`` ``[b, n_static]``, ``spatial_cond``
``[b, n_spatial, *sp]``. Sharding, export and the GNN path are not ported
yet.
"""

import sys
from contextlib import contextmanager

import numpy as np
import torch

import nps_tpu_torch.models as models
from nps_tpu_torch.compat.jax_weights import from_jax_params
from nps_tpu_torch.configs.parse import parse_args
from nps_tpu_torch.models.fno import packed_spectral_weights
from nps_tpu_torch.models.initializers import reset_parameters
from nps_tpu_torch.pde import PDE2D


def resolve_device(device):
    """``torch.device`` for ``device``; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return device


@contextmanager
def autotuned_convs():
    """Let cuDNN time its candidate algorithms once per conv shape
    (``cudnn.benchmark``) and restore the caller's setting after. A rollout
    repeats the same shapes, so the timing is paid once, in the first step.
    Left to its heuristics, cuDNN picks an FFT algorithm for the U-Net's f32
    convs with TF32 off, which on an H100 made a bundled step of the
    full-width U-FNO about 65x slower (``python -m nps_tpu_torch.trace_step``,
    PERF.md)."""
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = prev


class SurrogateEngine:
    def __init__(self, model, pde, time_window, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.pde = pde
        self.tw = time_window

    @classmethod
    def from_config(cls, config_file, checkpoint=None, overrides=(),
                    pde=None, device="cuda"):
        """Build from a training config file (same override semantics as the
        JAX package's CLI). The PDE metadata comes from ``pde``, else from
        the config's ``base_resolution``. The config's ``trainer.device`` is
        not read: ``device`` decides."""
        device = resolve_device(device)
        argv = sys.argv
        try:
            sys.argv = ["inference", *overrides]
            args = parse_args(config_file)
        finally:
            sys.argv = argv
        if args["trainer"].get("compute_dtype") not in (None, "float32"):
            raise NotImplementedError("compute_dtype is not ported yet")

        if pde is None:
            t_res, nx1, nx2 = args["trainer"]["base_resolution"]
            pde = PDE2D(tmin=0.0, tmax=1.0, nt=t_res, L1=1.0, L2=nx2 / nx1,
                        nx1=nx1, nx2=nx2, x=None,
                        name=args["dataset"].get("name", "pde"),
                        n_cond_static=args.get("n_cond_static", 0),
                        n_cond_spatial=args.get("n_cond_spatial", 0))

        model_args = dict(args["model"])
        obj = model_args.pop("object", "activation_wrapper")
        model = getattr(models, obj)(**model_args, pde=pde)
        eng = cls(model, pde, args["trainer"]["time_window"], device=device)
        if checkpoint is not None:
            eng.load(checkpoint)
        return eng

    # ------------------------------------------------------------------
    def init_params(self, seed=0):
        """Draw fresh torch-default weights from ``torch.Generator(seed)``
        (on the host, so a seed gives the same weights on any device)."""
        reset_parameters(self.model, torch.Generator().manual_seed(seed))
        return self.model.state_dict()

    def load(self, path):
        """Load a port or PyTorch-reference ``state_dict`` file (``.pt``)."""
        state = torch.load(path, map_location="cpu", weights_only=True)
        self.model.load_state_dict(state)
        return self

    def load_jax_params(self, tree):
        """Load an ``nps_tpu`` parameter tree (nested dicts of arrays)."""
        self.model.load_state_dict(from_jax_params(tree))
        return self

    # ------------------------------------------------------------------
    def _tensor(self, a):
        if a is None:
            return None
        t = torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        return None if t.numel() == 0 else t

    def _pos(self, batch):
        x = torch.as_tensor(np.asarray(self.pde.x, np.float32),
                            device=self.device)
        return x[None].expand((batch,) + tuple(x.shape))

    def _apply(self, u, cond, pos, spatial_cond):
        return self.model(u, cond=cond, pos=pos, spatial_cond=spatial_cond)

    def step(self, u, cond=None, spatial_cond=None):
        """One bundled step: [b, c, tw, *sp] -> the next tw frames."""
        with torch.inference_mode(), autotuned_convs(), \
                packed_spectral_weights(self.model):
            u = self._tensor(u)
            out = self._apply(u, self._tensor(cond), self._pos(u.shape[0]),
                              self._tensor(spatial_cond))
            return out.cpu().numpy()

    def rollout(self, u0, n_steps, cond=None, spatial_cond=None,
                include_init=False):
        """Autoregressive rollout from a [b, c, tw, *sp] seed window.

        Returns [b, c, n_steps*tw(+tw), *sp] predicted frames (numpy).
        """
        with torch.inference_mode(), autotuned_convs(), \
                packed_spectral_weights(self.model):
            pred = self._tensor(u0)
            cond, spatial_cond = self._tensor(cond), self._tensor(spatial_cond)
            pos = self._pos(pred.shape[0])
            frames = [pred] if include_init else []
            for _ in range(n_steps):
                pred = self._apply(pred, cond, pos, spatial_cond)
                frames.append(pred)
            return torch.cat(frames, dim=2).cpu().numpy()
