"""Encode-Process-Decode composition root and component resolver
(counterpart of ``nps_tpu/models/enc_proc_dec.py``, grid branch).

Components are given as a module instance, a dict / Namespace with an
``object`` key, or a dotted string, resolved against the registry
``[models.enc_proc_dec_components, models, models.common]``; the kwargs each
component does not declare are dropped. A spec's ``mix_impl`` (the JAX
package's route of its spectral convs) is checked here, and only here: the
port computes ``"dft"``, ``"xla"`` and ``"pallas"`` alike, and another value
raises. Public layout: ``u [b, c, tw, *sp]`` in and out, ``cond [b,
n_static]``, ``spatial_cond [b, n_spatial, *sp]``, ``pos [b, *sp, nd]``.

With ``data_structure="graph"`` (the MP-GNN, ``models/gnn.py``) ``u`` is a
:class:`~nps_tpu_torch.common.graph.GridGraph` of node tensors and the
output is ``[N, c, tw]``: the static conditioning is gathered to the nodes
by ``batch``, node positions (time column dropped) and the shifted path's
``grid_meta`` deltas are divided by the domain extent, and spatial
conditioning is warned about and ignored, as in the reference. The
components' ``n_cond`` is then the static conditioning's width.

With a ``bc_encoder`` spec (a :class:`~nps_tpu_torch.models.common.
BCEncoder`, given like any component) the boundary signal ``bc`` and the
time conditioning ``t_cond`` ([b, c, tw] each; concatenated along the
channels when both arrive) are encoded to ``bc_encoder_out`` values that
join the static conditioning before its broadcast to the grid (or the
nodes), and every component's ``n_cond`` grows by that width. Its
``bc_encoder_in`` is the spec's where it sets one, else the PDE's
``n_cond_dynamic``, as the reference sizes it. Without a BC encoder
``bc`` and ``t_cond`` are ignored, as in the JAX package.

Under pipeline parallelism (``parallel.scope`` of a pipe axis) the processor
chain runs pipelined over the pipe group (``parallel.pipeline.run``); the
encoder and the decoder run as they are on every pipe rank.
"""

import inspect
import warnings
from argparse import Namespace
from collections.abc import Mapping
from functools import reduce

import torch
from torch import nn

from nps_tpu_torch.models.config import cast_compute
from nps_tpu_torch.ops.spectral import check_mix_impl
from nps_tpu_torch.parallel import pipeline
from nps_tpu_torch.utils.attr import getattr_nested
from nps_tpu_torch.utils.broadcast import broadcast_to_grid


def _component_registry():
    import nps_tpu_torch.models as models
    import nps_tpu_torch.models.enc_proc_dec_components as components

    return [components, models, models.common]


def _filter_kwargs(cls, kwargs):
    """Drop the kwargs that ``cls`` does not declare."""
    sig = inspect.signature(cls)
    if any(p.kind is inspect.Parameter.VAR_KEYWORD
           for p in sig.parameters.values()):
        return dict(kwargs)
    return {k: v for k, v in kwargs.items() if k in sig.parameters}


def resolve_component(model, pde, base_args, extra_kwargs=None):
    """Resolve a component spec to (cls, kwargs); (instance, None) for an
    instance."""
    if isinstance(model, nn.Module):
        return model, None
    if not isinstance(model, (Mapping, Namespace, str)):
        raise ValueError("Model spec must be nn.Module / dict / Namespace / "
                         "str")
    if isinstance(model, str):
        model_class, model_kwargs = model, dict(base_args)
    else:
        model = dict(vars(model) if isinstance(model, Namespace) else model)
        model_class = model.pop("object")
        model_kwargs = {**base_args, **model}
    if extra_kwargs is not None:
        model_kwargs.update(extra_kwargs)
    # the JAX route a spec names; the port's one route computes all three
    check_mix_impl(model_kwargs.get("mix_impl", "dft"))
    for module in _component_registry():
        cls = getattr_nested(module, model_class)
        if cls is not False:
            return cls, dict(model_kwargs, pde=pde)
    raise ValueError(f"Cannot find object {model_class} in the component "
                     f"registry")


def create_model(model, pde, base_args, extra_kwargs=None):
    """Instantiate a component from its spec."""
    cls, kwargs = resolve_component(model, pde, base_args, extra_kwargs)
    if kwargs is None:
        return cls
    return cls(**_filter_kwargs(cls, kwargs))


class EncProcDec(nn.Module):
    """Composition root. Public layout: u [b, c, tw, *sp] in and out."""

    def __init__(self, pde=None, encoder=None, processor=None, decoder=None,
                 bc_encoder=None, num_c=1, num_spatial_dims=1, time_window=25,
                 data_structure="grid", processor_residual=False,
                 **base_args):
        super().__init__()
        if data_structure not in ("grid", "graph"):
            raise ValueError(f"data_structure must be 'grid' or 'graph', got "
                             f"{data_structure!r}")
        self.pde = pde
        self.num_spatial_dims = num_spatial_dims
        self.data_structure = data_structure
        self.processor_residual = processor_residual
        # graph nodes get the static conditioning only (spatial is ignored)
        self.n_cond = (pde.n_cond_static if data_structure == "graph"
                       else pde.n_cond_static + pde.n_cond_spatial)
        base = dict(base_args, num_c=num_c, num_spatial_dims=num_spatial_dims,
                    time_window=time_window)
        self.bc_encoder = None
        # the width of the conditioning vector the processors' ``variables``
        # carry: the static conditioning, and the BC encoder's code
        n_vars = pde.n_cond_static
        if bc_encoder is not None:
            self.bc_encoder = create_model(
                bc_encoder, pde, base,
                extra_kwargs=dict(bc_encoder_in=_bc_encoder_in(bc_encoder,
                                                               pde)))
            self.n_cond += self.bc_encoder.n_out
            n_vars += self.bc_encoder.n_out
        base.update(n_cond=self.n_cond, n_vars=n_vars)
        specs = (list(processor) if isinstance(processor, (list, tuple))
                 else [processor])
        self.processor_specs = specs
        self.encoder = create_model(encoder, pde, base)
        self.processor = nn.ModuleList(create_model(p, pde, base)
                                       for p in specs)
        self.decoder = create_model(decoder, pde, base)
        self._takes_variables = [
            "variables" in inspect.signature(p.forward).parameters
            for p in self.processor]

    @property
    def model_interface(self):
        mi = [p.model_interface for p in self.processor]
        assert mi.count(mi[0]) == len(mi), \
            "Not all processors have the same model interface!"
        return mi[0]

    @property
    def data_interface(self):
        return reduce(set.intersection,
                      [set(p.data_interface) for p in self.processor])

    def forward(self, u, cond=None, bc=None, pos=None, t_cond=None,
                spatial_cond=None, grid_meta=None):
        """``grid_meta``: for the graph branch, the host-side regular-grid
        structure of ``common.graph.grid_offset_structure`` (or None), which
        selects the MP-GNN's shifted path."""
        def check_none(x):
            return None if (x is None or x.numel() == 0) else x

        cond = check_none(cond)
        spatial_cond = check_none(spatial_cond)
        variables = self._embed(cond, check_none(bc), check_none(t_cond))
        extra = {}
        if self.data_structure == "graph":
            u, vb, pos, extra = self._graph_inputs(u, variables,
                                                   spatial_cond, grid_meta)
        else:
            # conditioning broadcast to the grid, channel-first
            # [b, n_cond, *sp]
            sp = tuple(u.shape[3:])
            vb = (broadcast_to_grid(variables, sp) if variables is not None
                  else None)
            if spatial_cond is not None:
                vb = (spatial_cond if vb is None
                      else torch.cat([vb, spatial_cond], dim=1))
        if vb is not None:
            # in the compute dtype, so that the concats downstream do not
            # promote bf16 activations back to f32
            vb = cast_compute(vb)

        h = self.encoder(u=u, variables_broadcast=vb, pos=pos, **extra)
        axis = pipeline.current()
        if axis is not None:
            h = pipeline.run(self, h, variables, vb, pos, axis)
        else:
            h = self._process(h, variables, vb, pos, extra)
        return self.decoder(h, u, variables=variables,
                            variables_broadcast=vb, pos=pos, **extra)

    def _embed(self, cond, bc, t_cond):
        """The conditioning vector [b, n]: ``cond``, then the BC encoder's
        code of ``bc`` and ``t_cond`` (concatenated where both arrive);
        None where nothing arrives."""
        parts = [] if cond is None else [cond]
        bc_in = [t for t in (bc, t_cond) if t is not None]
        if self.bc_encoder is not None:
            if not bc_in:
                raise ValueError(
                    "the model has a BC encoder, and neither bc nor t_cond "
                    "arrived: its processors take the encoder's "
                    f"{self.bc_encoder.n_out} conditioning channels")
            parts.append(self.bc_encoder(torch.cat(bc_in, dim=1)
                                         if len(bc_in) > 1 else bc_in[0]))
        if not parts:
            return None
        return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]

    def _process(self, h, variables, vb, pos, extra):
        """The processor chain on h."""
        for i, (proc, takes_vars) in enumerate(zip(self.processor,
                                                   self._takes_variables)):
            kwargs = dict(variables_broadcast=vb, pos=pos, **extra)
            if takes_vars:
                kwargs["variables"] = variables
            h_next = proc(h, **kwargs)
            h = h_next + h if (self.processor_residual and i > 0) else h_next
        return h

    def _graph_inputs(self, graph, variables, spatial_cond, grid_meta):
        """The graph branch's (nodes, node conditioning, normalised node
        positions, graph kwargs for the components)."""
        if spatial_cond is not None:
            warnings.warn("spatial conditioning is not supported for "
                          "data_structure == 'graph'; ignoring it")
        nd = self.num_spatial_dims
        vb = variables[graph.batch] if variables is not None else None
        pos = graph.pos[:, 1:]   # drop the time column
        if pos.shape[-1] != nd:
            raise ValueError(f"graph pos has {pos.shape[-1]} spatial dims, "
                             f"the model expects {nd}")
        extent = [float(v) for v in (self.pde.L if nd > 1
                                     else [self.pde.L])]
        # per column by a host scalar: no host-to-device copy (CUDA graphs)
        pos = torch.stack([pos[:, d] / e for d, e in enumerate(extent)],
                          dim=-1)
        if grid_meta is not None:
            # the per-offset deltas are normalised like pos, on the host
            sp, offsets, deltas = grid_meta
            grid_meta = (tuple(sp), offsets, tuple(
                tuple(float(d) / s for d, s in zip(dd, extent))
                for dd in deltas))
        return graph.nodes, vb, pos, dict(
            edge_index=graph.edge_index, batch=graph.batch,
            grid_meta=grid_meta)


def _bc_encoder_in(spec, pde):
    """The BC encoder's input channels: its spec's ``bc_encoder_in``, else
    the PDE's ``n_cond_dynamic``."""
    if isinstance(spec, Namespace):
        spec = vars(spec)
    if isinstance(spec, Mapping) and spec.get("bc_encoder_in") is not None:
        return int(spec["bc_encoder_in"])
    return pde.n_cond_dynamic
