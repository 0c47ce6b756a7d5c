"""Mixture-of-spectral-experts FNO processor (counterpart of
``nps_tpu/models/moe_fno.py``; the reference has no MoE).

``hidden_blocks`` x (a softmax gate and ``n_experts`` FNO layers). Every
expert runs on every sample and the gate mixes them, with the activation
applied after the sum::

    h = act(sum_e g[b, e] * Expert_e(h_in)[b])

where ``h_in`` is ``h`` with the broadcast conditioning concatenated
(``cond_mode="concat"``). The gate is a ``Dense(n_gate_in -> E)`` on the
model-level conditioning vector (``variables``: the static conditioning
and a BC encoder's code),
or, for a model without one, on the spatial mean of ``h``;
its logits go through the softmax in f32 and the gate is then cast to the
experts' output type; the weighted outputs are summed in f32 and rounded
once to that type. With ``n_experts=1`` the gate is the constant 1 and a
block is exactly an ``FNO_Layer`` with the activation.

Each expert is its own :class:`~nps_tpu_torch.models.fno.FNO_Layer`
(``activation=None``), so each launches its spectral conv (the K1 kernel on
the card) once per apply: ``hidden_blocks * n_experts`` calls.
``remat`` rematerializes each expert layer in the backward
(:func:`~nps_tpu_torch.models.common.remat_block`), as the JAX package
wraps ``FNO_Layer`` in ``nn.remat``. FiLM conditioning is refused.

Under expert parallelism (``parallel.scope`` of an expert axis) rank r of K
runs only its experts [r E / K, (r + 1) E / K) of each block (the others'
parameters are empty there): their gated terms, summed in f32, are summed over
the expert group (``parallel.expert.expert_sum``), and the block's input and
its conditioning enter the block through ``parallel.tensor.copy_in``, ahead of
the experts and of the gate: each rank's gradient into them is partial (a BC
encoder's code reaches both).

Under spatial parallelism (``parallel.scope`` of an x axis: h holds this
rank's rows) each expert's spectral conv runs split (K1's split entries on
the card; in 3D the split ``torch.fft`` route), and a pooled gate reads the
grid's mean: the local rows' sums summed over the x group
(``parallel.spatial.spatial_sum``), over the global cell count, as the JAX
package's ``jnp.mean`` of the whole field.

Parameter names (the JAX package stacks each expert's leaves on a leading
``E`` axis; :func:`~nps_tpu_torch.compat.jax_weights.from_jax_params`
splits it): ``processor.P.experts.i.e.<FNO_Layer keys>`` for expert ``e``
of block ``i`` (JAX ``processor_P/experts_i/...`` at index ``e``), and
``processor.P.gate.i.weight`` ``[E, n_gate_in]`` / ``.bias`` ``[E]`` (JAX
``gate_i/kernel`` ``[n_gate_in, E]`` / ``bias``).
"""

import math

import torch
from torch import nn

from nps_tpu_torch.common.interfaces import D, M
from nps_tpu_torch.models.activations import resolve_activation
from nps_tpu_torch.models.common import REMAT_POLICIES, Dense, remat_block
from nps_tpu_torch.models.config import compute_dtype_scope
from nps_tpu_torch.models.fno import FNO_Layer
from nps_tpu_torch.parallel import expert, spatial, tensor


class MoEFNO(nn.Module):
    """``hidden_blocks`` x (gated mixture of ``n_experts`` FNO layers),
    h [b, hidden, *sp] in and out."""

    model_interface = M.AR_TB
    data_interface = (D.sim1d, D.sim1d_var_t, D.sim2d)

    def __init__(self, pde=None, num_spatial_dims=1, n_cond=0,
                 hidden_features=128, hidden_blocks=4, cond_mode="concat",
                 padding_mode="circular", activation="gelu", n_experts=4,
                 fno_modes=48, fno_kernel_size=1, fno_conv_mode="single",
                 remat=False, remat_policy=None, n_vars=None):
        super().__init__()
        assert cond_mode in ("concat", None), \
            "MoEFNO conditions by concat (+ the gate); FiLM is not supported"
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"Unknown remat policy {remat_policy!r}")
        self.cond_mode = cond_mode
        self.nd = num_spatial_dims
        self.remat, self.remat_policy = bool(remat), remat_policy
        self.hidden_blocks = int(hidden_blocks)
        self.act = resolve_activation(activation)
        E = int(n_experts)
        hidden_in = (hidden_features + n_cond if cond_mode == "concat"
                     else hidden_features)
        pm = padding_mode if padding_mode != "ones" else "zeros"
        # the gate reads the model-level conditioning vector (n_vars wide,
        # from the EncProcDec: the static conditioning and a BC encoder's
        # code; the static conditioning's where none is given) where the
        # model has one, else the pooled hidden state
        if n_vars is None:
            n_vars = int(getattr(pde, "n_cond_static", 0) or 0)
        self.n_gate_in = n_vars or hidden_features
        self.gate = nn.ModuleList(Dense(self.n_gate_in, E)
                                  for _ in range(hidden_blocks))
        self.experts = nn.ModuleList(
            nn.ModuleList(
                FNO_Layer(hidden_dim=hidden_in,
                          hidden_dim_out=hidden_features,
                          num_spatial_dims=num_spatial_dims, modes=fno_modes,
                          kernel_size=fno_kernel_size,
                          conv_mode=fno_conv_mode, padding_mode=pm,
                          activation=None)
                for _ in range(E))
            for _ in range(hidden_blocks))

    def block(self, i, h, variables=None, variables_broadcast=None,
              pos=None):
        """Block ``i`` (the gated mixture of its experts, activated) on h."""
        gate, experts = self.gate[i], self.experts[i]
        axis = expert.current()
        local = range(len(experts))
        if axis is not None:
            # every use below of h and of the conditioning (the experts and
            # the gate; a BC encoder's code is in both) gives only this
            # rank's part of its gradient: summed over the group
            local = range(*axis.part(len(experts)))
            h, variables, variables_broadcast = (
                None if t is None else tensor.copy_in(t, axis)
                for t in (h, variables, variables_broadcast))
        h_in = (torch.cat([h, variables_broadcast], dim=1)
                if (self.cond_mode == "concat"
                    and variables_broadcast is not None) else h)
        gate_in = (variables if variables is not None
                   else self._pooled(h))
        if gate_in.shape[-1] != self.n_gate_in:
            raise ValueError(
                f"the gate was built for {self.n_gate_in} inputs, got "
                f"{gate_in.shape[-1]} (static conditioning given to a "
                "model built without it, or the other way round)")
        # f32 logits and softmax, whatever the compute dtype
        with compute_dtype_scope(None):
            g = torch.softmax(gate(gate_in.float()), dim=-1)
        acc = None
        for e in local:
            layer = experts[e]
            if self.remat:
                layer = remat_block(layer, self.remat_policy)
            out = layer(h_in)
            # g[:, e] rounded to the expert's output type, [b, 1, ...];
            # the mixture is summed in f32 and rounded once
            ge = g[:, e].to(out.dtype).float().reshape(
                (-1,) + (1,) * (out.ndim - 1))
            term = out.float() * ge
            acc = term if acc is None else acc + term
        if axis is not None:
            acc = expert.expert_sum(acc, axis)
        return self.act(acc.to(out.dtype))

    def _pooled(self, h):
        """The spatial mean of h [b, c, *sp] -> [b, c]; under a row split
        the grid's: the local rows' f32 sums summed over the x group
        (``spatial_sum``), over the global cell count."""
        dims = tuple(range(2, 2 + self.nd))
        axis = spatial.current()
        if axis is None:
            return h.mean(dim=dims)
        total = spatial.spatial_sum(h.float().sum(dim=dims), axis)
        return (total / (axis.rows * math.prod(h.shape[3:]))).to(h.dtype)

    def forward(self, h, variables=None, variables_broadcast=None, pos=None):
        for i in range(self.hidden_blocks):
            h = self.block(i, h, variables, variables_broadcast, pos)
        return h
