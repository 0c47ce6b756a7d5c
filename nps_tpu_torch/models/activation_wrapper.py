"""Physics post-processing around a model's output (counterpart of
``nps_tpu/models/activation_wrapper.py``): final activation, obstacle
masking and approximate volume (mass) preservation.

As in the PyTorch reference, the wrapper is a subclass of the wrapped model
built on the fly, so its parameters keep the wrapped model's key names (no
``inner.`` prefix) and the reference's checkpoints load unchanged. Under
spatial parallelism the volume totals are sums over the x group.
"""

from functools import lru_cache

import torch

from nps_tpu_torch.models.activations import resolve_activation
from nps_tpu_torch.parallel import spatial


def _apply_spatial_cond(spatial_cond, u, channel):
    to_zero = spatial_cond[:, channel][:, None, None, ...]  # [b, 1, 1, *sp]
    return u - to_zero * u


def _domain_sum(t, dims):
    """``t`` summed over the spatial ``dims``: under spatial parallelism
    this rank's rows summed over the x group (``spatial_sum``, whose
    backward sums over the x group too)."""
    s = t.sum(dim=dims)
    axis = spatial.current()
    return s if axis is None else spatial.spatial_sum(s, axis)


def volume_preserve(u, u_prev, mode, max_pct_dif):
    """Rescale the frames of ``u`` toward the spatial integral of the last
    input frame of ``u_prev``; u, u_prev: [b, c, tw, *sp]. Modes 'block',
    'individual' (sequential over tw) and 'individual_static'."""
    sp_axes = tuple(range(3, u.ndim))
    if len(sp_axes) != 2:
        raise ValueError(f"{len(sp_axes)} spatial dims not supported for "
                         f"approx volume preserve")
    tw = u.shape[2]
    expand = (...,) + (None,) * len(sp_axes)
    new_totals = _domain_sum(u, sp_axes)                       # [b, c, tw]
    prev_totals = _domain_sum(u_prev[:, :, -1],
                              tuple(a - 1 for a in sp_axes))

    def soft_clip(dif, limit):
        return torch.tanh(dif / limit) / 100.0 * limit

    if mode == "block":
        new_mean = new_totals.mean(dim=2)                      # [b, c]
        dif = soft_clip((1.0 - new_mean / prev_totals) * 100.0, max_pct_dif)
        full = (...,) + (None,) * (u.ndim - 2)                # [b, c, 1, 1, 1]
        return (u / new_mean[full]) * (prev_totals * (1.0 - dif))[full]

    if mode == "individual":
        prev = prev_totals
        scales = []
        for i in range(tw):
            dif = soft_clip((1.0 - new_totals[:, :, i] / prev) * 100.0,
                            max_pct_dif)
            r = 1.0 - dif
            scales.append(r * prev / new_totals[:, :, i])
            prev = r * prev
        return u * torch.stack(scales, dim=2)[expand]

    if mode == "individual_static":
        prev_all = prev_totals[:, :, None].expand(-1, -1, tw)
        max_all = max_pct_dif * torch.arange(1, tw + 1, dtype=u.dtype,
                                             device=u.device)
        dif = soft_clip((1.0 - new_totals / prev_all) * 100.0, max_all)
        scale = ((1.0 - dif) * prev_all) / new_totals
        return u * scale[expand]

    raise ValueError(f"Unrecognized approx_volume_preserve_mode '{mode}'")


class ActivationWrapper:
    """Mixin placed before the wrapped model's class: post-processes its
    ``forward`` output."""

    def __init__(self, *args, activation_final=None,
                 enforce_spatial_cond=False, spatial_cond_channel=0,
                 approx_volume_preserve=False,
                 approx_volume_preserve_mode="block", max_pct_dif=1.0,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.activation_final = resolve_activation(activation_final)
        self.enforce_spatial_cond = enforce_spatial_cond
        self.spatial_cond_channel = spatial_cond_channel
        self.approx_volume_preserve = approx_volume_preserve
        self.approx_volume_preserve_mode = approx_volume_preserve_mode
        self.max_pct_dif = max_pct_dif

    def forward(self, u, cond=None, bc=None, pos=None, t_cond=None,
                spatial_cond=None):
        out = self.activation_final(super().forward(
            u, cond=cond, bc=bc, pos=pos, t_cond=t_cond,
            spatial_cond=spatial_cond))
        if self.enforce_spatial_cond:
            out = _apply_spatial_cond(spatial_cond, out,
                                      self.spatial_cond_channel)
        if self.approx_volume_preserve:
            out = volume_preserve(out, u, self.approx_volume_preserve_mode,
                                  self.max_pct_dif)
            if self.enforce_spatial_cond:
                out = _apply_spatial_cond(spatial_cond, out,
                                          self.spatial_cond_channel)
        return out


@lru_cache(maxsize=None)
def _wrapped_class(base):
    return type(f"Wrapped{base.__name__}", (ActivationWrapper, base), {})


def activation_wrapper(model_class, activation_final,
                       enforce_spatial_cond=False, spatial_cond_channel=0,
                       approx_volume_preserve=False,
                       approx_volume_preserve_mode="block", max_pct_dif=1,
                       *args, **kwargs):
    """Build ``model_class`` (a registry name) wrapped with the physics
    output constraints."""
    from nps_tpu_torch.models.enc_proc_dec import _component_registry
    from nps_tpu_torch.utils.attr import getattr_nested

    for module in _component_registry():
        base = getattr_nested(module, model_class)
        if base is not False:
            break
    else:
        raise ValueError(f"Model {model_class} not found")
    return _wrapped_class(base)(
        *args, activation_final=activation_final,
        enforce_spatial_cond=enforce_spatial_cond,
        spatial_cond_channel=spatial_cond_channel,
        approx_volume_preserve=approx_volume_preserve,
        approx_volume_preserve_mode=approx_volume_preserve_mode,
        max_pct_dif=max_pct_dif, **kwargs)
