"""The two forward kernels as ``torch.library`` custom ops.

``nps_torch::gn1_gelu_fwd`` (K2, ``csrc/gn1_gelu.cu``) and
``nps_torch::spectral_dft2d_fwd`` (K1, ``csrc/spectral_dft2d.cu``). Each op
has three implementations:

- CUDA: the kernel's launch (:func:`group_norm.gn1_gelu_fwd`,
  :func:`spectral.spectral_dft2d_fwd`): outputs allocated by torch, the
  kernel launched on the current stream, a failed build or launch raises;
- CPU: the plain version (:func:`group_norm.gn_gelu_plain`,
  :func:`spectral.spectral_conv_2d_packed_plain`);
- fake: output shape and dtype only (the input's type, f32 or bf16), with
  no guard on the batch, so a symbolic batch passes through
  ``torch.export``.

The no-grad serving path of ``gn_gelu`` and ``spectral_conv_nd`` calls these
ops on both devices, so an exported graph holds them as nodes and a CUDA
graph captures their launches. The grad path (``GNGeluFn``,
``SpectralConv2dFn``, plain autograd on the CPU) does not go through them.
The implementations look their launch and plain functions up on the module
at call time, so a caller that replaces one there (a test, a shape
recorder) is seen.
"""

from typing import Optional

import torch

from nps_tpu_torch.ops import group_norm as gn
from nps_tpu_torch.ops import spectral as sp


@torch.library.custom_op("nps_torch::gn1_gelu_fwd", mutates_args=(),
                         device_types="cuda")
def gn1_gelu_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 gelu: bool, eps: float,
                 approximate: str = "none") -> torch.Tensor:
    """GroupNorm(1 group) [+ GELU, exact ("none") or "tanh"] of x
    [b, C, *sp]: the kernel."""
    return gn.gn1_gelu_fwd(x, weight, bias, gelu, eps, approximate)


@gn1_gelu_fwd.register_kernel("cpu")
def _gn1_gelu_fwd_cpu(x, weight, bias, gelu, eps, approximate="none"):
    return gn.gn_gelu_plain(x, weight, bias, gelu, eps, approximate)


@gn1_gelu_fwd.register_fake
def _gn1_gelu_fwd_fake(x, weight, bias, gelu, eps, approximate="none"):
    return torch.empty_like(x)


@torch.library.custom_op("nps_torch::spectral_dft2d_fwd", mutates_args=(),
                         device_types="cuda")
def spectral_dft2d_fwd(x: torch.Tensor, w_packed: torch.Tensor, m1: int,
                       m2: int, film: Optional[torch.Tensor],
                       film_mode: int) -> torch.Tensor:
    """The truncated-DFT spectral conv of x [b, ci, n1, n2] (f32 or bf16)
    with the f32 weight pack [2*m1*m2, 2, ci, co]
    (:func:`spectral.pack_weights_2d`), in x's type: the kernel (its
    resident or its large-plane variant)."""
    return sp.spectral_dft2d_fwd(x, w_packed, (m1, m2), film, film_mode)


@spectral_dft2d_fwd.register_kernel("cpu")
def _spectral_dft2d_fwd_cpu(x, w_packed, m1, m2, film, film_mode):
    # contiguous, as the kernel writes it
    return sp.spectral_conv_2d_packed_plain(x, w_packed, (m1, m2), film,
                                            film_mode).contiguous()


@spectral_dft2d_fwd.register_fake
def _spectral_dft2d_fwd_fake(x, w_packed, m1, m2, film, film_mode):
    # the output has x's type (f32 or bf16), as the kernel and the plain
    # version give it
    return x.new_empty((x.shape[0], w_packed.shape[3]) + tuple(x.shape[2:]))
