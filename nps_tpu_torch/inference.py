"""Serving API (counterpart of ``nps_tpu/inference.py``): build a surrogate
from a training config, load weights, run autoregressive rollouts, and
export a rollout as a self-contained artifact.

    from nps_tpu_torch.inference import SurrogateEngine, load_exported
    eng = SurrogateEngine.from_config(
        "nps_tpu_torch/configs/train/cfg_twophase_ufno.py", pde=my_pde)
    eng.init_params(seed=0)                 # or eng.load("weights.pt")
    frames = eng.rollout(u0, n_steps=19, cond=cond, spatial_cond=sc)
    frames = eng.rollout(u0, 19, cond=cond, spatial_cond=sc, captured=True)
    eng.export_rollout("surrogate.npst", 19, u0, cond=cond, spatial_cond=sc)
    frames = load_exported("surrogate.npst").rollout(u0, cond, sc)

The engine runs on ``device`` ("cuda" unless the caller asks for "cpu"); on
the GPU the model goes through the hand-written kernels. Three ways to
serve a rollout:

- eager (the default): a Python loop of model applications under
  ``torch.inference_mode()``, with cuDNN choosing each convolution's
  algorithm by timing among its deterministic ones (see
  :func:`autotuned_convs`), so a rollout gives the same bits every call,
  and the spectral weights packed once per call of ``step`` or ``rollout``;
- captured (``captured=True``, CUDA only): the whole ``n_steps`` rollout
  captured once in one CUDA graph per (n_steps, shapes), after an eager
  warm-up step that lets cuDNN time its algorithms; later calls copy their
  inputs into the graph's and replay it. The graph keeps the spectral packs
  it was captured with, so ``load``, ``load_jax_params`` and
  ``init_params`` drop the captured graphs; weights changed in place by
  other means need :meth:`SurrogateEngine.clear_captured`. The counterpart
  of the JAX package's one jitted ``lax.scan`` per shape;
- exported (:meth:`SurrogateEngine.export_rollout`, :func:`load_exported`):
  ``torch.export`` of one bundled step, the weights, the spectral packs and
  the position grid baked in, the kernels kept as the custom ops
  ``nps_torch::gn1_gelu_fwd`` and ``nps_torch::spectral_dft2d_fwd``. It
  serves without the config system, the model code or the checkpoint.

The engine has a compute dtype (``compute_dtype``: its argument, else its
config's ``trainer.compute_dtype``; f32 when neither sets one, as in the
JAX package's ``from_config``) and runs every model apply, capture and
export inside :func:`~nps_tpu_torch.models.config.compute_dtype_scope`: in
bf16 the activations flow in bf16 through the convs and both kernels, with
f32 weights, f32 sums and an f32 physics wrapper, so the frames it returns
are f32 either way. The MP-GNN refuses bf16 (ROADMAP P12c).

Inputs and outputs are numpy arrays in the JAX package's layout: ``u`` is
``[b, c, tw, *sp]``, ``cond`` ``[b, n_static]``, ``spatial_cond``
``[b, n_spatial, *sp]``. A model with a BC encoder (boundary or time
conditioning) is refused at construction, since a rollout here takes
neither signal, as in the JAX package. GNN configs
(``data_structure="graph"``) convert
grid windows to node space at the model boundary over a static graph built
once per batch size; they serve eagerly and captured, and refuse export.

:meth:`SurrogateEngine.shard` serves across the processes of a
``torch.distributed`` group (``parallel.init_distributed``), one device
each, as the JAX engine's ``shard`` serves over a device mesh:
``spatial_parallel=0`` splits the rollout batch over the ranks,
``spatial_parallel=K`` lays them out as a (data, x) grid and splits the
first spatial axis of the fields over the K ranks of each x group as well
(``parallel.spatial``; a 1D model runs whole on each x rank). Every rank
calls ``rollout`` with the whole inputs and gets the whole frames back.
``export_rollout`` on a sharded engine exports the unsharded step from the
replicated weights, outside any grid scope, as the JAX engine's export
reads its params and never its mesh: it makes no collective, so one rank
may call it alone, and the artifact serves on one device. ``captured=True``
on a sharded engine raises: a gloo collective cannot be captured into a
CUDA graph, and capturing the grid's collectives under NCCL is ROADMAP §2's
work (the grid collectives under NCCL); serve it eagerly.
"""

import io
import json
import sys
from contextlib import contextmanager

import numpy as np
import torch
from torch import nn

import nps_tpu_torch.models as models
from nps_tpu_torch.common import graph as G
from nps_tpu_torch.common.interfaces import M
from nps_tpu_torch.compat.jax_weights import from_jax_params
from nps_tpu_torch.configs.parse import parse_args
from nps_tpu_torch.models.config import (compute_dtype_scope,
                                         resolve_compute_dtype)
from nps_tpu_torch.models.fno import SpectralConvND, packed_spectral_weights
from nps_tpu_torch.models.initializers import reset_parameters
from nps_tpu_torch.parallel import spatial
from nps_tpu_torch.pde import PDE2D

# the port's artifact magic (the JAX package's NPSX0001 names a jax.export
# artifact)
ARTIFACT_MAGIC = b"NPSTX001"


def resolve_device(device):
    """``torch.device`` for ``device``; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return device


@contextmanager
def autotuned_convs(deterministic=False):
    """Let cuDNN time its candidate algorithms once per conv shape
    (``cudnn.benchmark``) and restore the caller's settings after. A rollout
    repeats the same shapes, so the timing is paid once, in the first step.
    Left to its heuristics, cuDNN picks an FFT algorithm for the U-Net's f32
    convs with TF32 off, which on an H100 made a bundled step of the
    full-width U-FNO about 65x slower (``python -m nps_tpu_torch.trace_step``,
    PERF.md).

    With ``deterministic`` the timing considers only cuDNN's deterministic
    algorithms (``cudnn.deterministic``), as the serving engine asks: the
    fastest candidates for the U-Net up path's transposed convs sum in no
    fixed order, so two eager rollouts differed, a captured one could not
    be held to the eager one, and a serving step against the CPU read up
    to 4.9e-5 in some processes (PERF.md)."""
    prev = (torch.backends.cudnn.benchmark,
            torch.backends.cudnn.deterministic)
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.deterministic = deterministic or prev[1]
    try:
        yield
    finally:
        (torch.backends.cudnn.benchmark,
         torch.backends.cudnn.deterministic) = prev


def _frames(frames, u0, include_init):
    """Concatenate bundled-step outputs [b, c, tw, *sp] along time (with
    the seed window first when ``include_init``): numpy."""
    if include_init:
        frames = [u0, *frames]
    return torch.cat(frames, dim=2).cpu().numpy()


class SurrogateEngine:
    def __init__(self, model, pde, time_window, device="cuda", neighbors=3,
                 compute_dtype=None):
        if getattr(model, "bc_encoder", None) is not None:
            # the JAX engine applies the model with bc=None, t_cond=None: it
            # cannot feed a BC encoder, and a rollout of such a model's
            # weights fails there
            raise ValueError(
                "SurrogateEngine serves no model with a BC encoder: its "
                "rollout takes no bc or t_cond (as the JAX package's "
                "engine); roll it out with the trainer's simulate(..., "
                "t_conditioning=...)")
        self.device = resolve_device(device)
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.model = model.to(self.device).eval()
        self.pde = pde
        self.tw = time_window
        self.neighbors = neighbors  # GNN edge rule (trainer.neighbors)
        self._graph_cache = {}
        self._captured = {}
        self._pos_grid = None
        # shard(): the (data, x) grid, or the data split (index, extent)
        self._grid = None
        self._data = None

    @classmethod
    def from_config(cls, config_file, checkpoint=None, overrides=(),
                    pde=None, device="cuda", compute_dtype=None):
        """Build from a training config file (same override semantics as the
        JAX package's CLI). The PDE metadata comes from ``pde``, else from
        the config's ``base_resolution``. The config's ``trainer.device`` is
        not read: ``device`` decides. The compute dtype is ``compute_dtype``,
        else the config's ``trainer.compute_dtype``."""
        device = resolve_device(device)
        argv = sys.argv
        try:
            sys.argv = ["inference", *overrides]
            args = parse_args(config_file)
        finally:
            sys.argv = argv
        dtype = compute_dtype or args["trainer"].get("compute_dtype")

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
        eng = cls(model, pde, args["trainer"]["time_window"], device=device,
                  neighbors=args["trainer"].get("neighbors", 3),
                  compute_dtype=dtype)
        if checkpoint is not None:
            eng.load(checkpoint)
        return eng

    # ------------------------------------------------------------------
    def init_params(self, seed=0):
        """Draw fresh torch-default weights from ``torch.Generator(seed)``
        (on the host, so a seed gives the same weights on any device)."""
        reset_parameters(self.model, torch.Generator().manual_seed(seed))
        self.clear_captured()
        return self.model.state_dict()

    def load(self, path):
        """Load a port or PyTorch-reference ``state_dict`` file (``.pt``)."""
        state = torch.load(path, map_location="cpu", weights_only=True)
        self.model.load_state_dict(state)
        self.clear_captured()
        return self

    def load_jax_params(self, tree):
        """Load an ``nps_tpu`` parameter tree (nested dicts of arrays)."""
        self.model.load_state_dict(from_jax_params(tree))
        self.clear_captured()
        return self

    def clear_captured(self):
        """Drop the captured rollouts (they hold the weights' packs)."""
        self._captured.clear()

    # ------------------------------------------------------------------
    def shard(self, spatial_parallel=0):
        """Serve across the processes of the initialised ``torch.distributed``
        group (a collective: every rank calls it, and then every rollout).
        ``spatial_parallel`` 0 or 1 splits the rollout batch over the ranks;
        K > 1 lays them out as a (data, x) grid of D x K (``parallel.Grid``)
        and splits the fields' first spatial axis over each x group too.
        Rank 0's weights are broadcast to every rank. The MP-GNN refuses,
        as the JAX engine's ``shard`` does; a 1D model runs whole on each
        x rank (``parallel.spatial.whole``), and the 2D and 3D grid models
        split their rows."""
        from nps_tpu_torch import parallel

        if self._is_gnn():
            raise NotImplementedError(
                "sharded serving takes grid models, as the JAX engine's "
                "shard does: the MP-GNN's graph is built per batch size")
        if not torch.distributed.is_initialized():
            raise RuntimeError("shard() serves across a torch.distributed "
                               "group: call parallel.init_distributed first")
        k = int(spatial_parallel or 0)
        if k > 1:
            spatial.check_model(self.model, None, k)
            self._grid = parallel.Grid(k, whole=spatial.whole(self.model))
            self._data = (self._grid.data_index, self._grid.data_size)
        else:
            self._grid, self._data = None, parallel.world()
        parallel.replicate(self.model)
        self.clear_captured()
        return self

    def _sharded_rollout(self, u0, n_steps, cond, spatial_cond, include_init):
        """The eager rollout of a sharded engine: this rank's elements (and
        rows), then the whole frames gathered on every rank."""
        from nps_tpu_torch import parallel

        u0 = self._tensor(u0)
        cond, sc = self._tensor(cond), self._tensor(spatial_cond)
        index, extent = self._data
        b = u0.shape[0]
        if b % extent:
            raise ValueError(f"a rollout batch of {b} does not split over "
                             f"the {extent} data slices")
        mine = slice(index * b // extent, (index + 1) * b // extent)
        u = u0[mine]
        c = None if cond is None else cond[mine]
        s = None if sc is None else sc[mine]
        pos = self._pos(u.shape[0])
        axis = None
        if self._grid is not None and self._grid.split:
            spatial.check_model(self.model, u.shape[3], self._grid.axis.size)
            axis = self._grid.axis.at(u.shape[3])
            _, u, pos, _, _, s = self._grid.shard_batch((u, u, pos, c, None,
                                                         s))
        with self._serving(), spatial.scope(axis):
            pred, frames = u, []
            for _ in range(n_steps):
                pred = self._apply(pred, c, pos, s)
                frames.append(pred)
            out = torch.cat(frames, dim=2)
            out = (parallel.gather_rows(out) if self._grid is None
                   else self._grid.gather_frames(out))
            return _frames([out], u0, include_init)

    def _is_gnn(self):
        return self.model.model_interface == M.AR_TB_GNN

    def _ensure_graph(self, batch_size):
        """The static graph structure for GNN models on the device: (edges,
        node pos, batch ids, grid_meta), built once per batch size."""
        key = int(batch_size)
        if key not in self._graph_cache:
            self._graph_cache[key] = G.structure_on(
                self.device, self.pde, self.pde.x, self.neighbors, key)
        return self._graph_cache[key]

    def _tensor(self, a):
        if a is None:
            return None
        t = torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        return None if t.numel() == 0 else t

    def _pos(self, batch):
        """The position grid [batch, *sp, nd] on the device (an expanded
        view of one copy, made once)."""
        if self._pos_grid is None:
            with torch.inference_mode(False):
                self._pos_grid = torch.as_tensor(
                    np.asarray(self.pde.x, np.float32), device=self.device)
        x = self._pos_grid
        return x[None].expand((batch,) + tuple(x.shape))

    def _apply(self, u, cond, pos, spatial_cond):
        """Model apply, with grid <-> node conversion for GNN models."""
        if self._is_gnn():
            return G.apply_on_grid(self.model, u,
                                   self._ensure_graph(u.shape[0]), cond=cond,
                                   pos=pos, spatial_cond=spatial_cond)
        return self.model(u, cond=cond, pos=pos, spatial_cond=spatial_cond)

    @contextmanager
    def _serving(self):
        """What every serving apply runs inside: inference mode, cuDNN
        timing among its deterministic algorithms, the spectral weights
        packed once, and the engine's compute dtype."""
        with torch.inference_mode(), autotuned_convs(deterministic=True), \
                packed_spectral_weights(self.model), \
                compute_dtype_scope(self.compute_dtype):
            yield

    def step(self, u, cond=None, spatial_cond=None):
        """One bundled step: [b, c, tw, *sp] -> the next tw frames."""
        if self._data is not None:
            return self._sharded_rollout(u, 1, cond, spatial_cond, False)
        with self._serving():
            u = self._tensor(u)
            out = self._apply(u, self._tensor(cond), self._pos(u.shape[0]),
                              self._tensor(spatial_cond))
            return out.cpu().numpy()

    def rollout(self, u0, n_steps, cond=None, spatial_cond=None,
                include_init=False, captured=False):
        """Autoregressive rollout from a [b, c, tw, *sp] seed window.

        Returns [b, c, n_steps*tw(+tw), *sp] predicted frames (numpy). With
        ``captured=True`` (CUDA only) the rollout replays one CUDA graph
        per (n_steps, input shapes), captured at its first call.
        """
        if captured:
            if self._data is not None:
                raise NotImplementedError(
                    "captured=True on a sharded engine: a gloo collective "
                    "cannot be captured into a CUDA graph, and capturing the "
                    "grid's collectives under NCCL is not written (ROADMAP "
                    "§2, the grid collectives under NCCL); serve it eagerly")
            return self._captured_rollout(u0, n_steps, cond, spatial_cond,
                                          include_init)
        if self._data is not None:
            return self._sharded_rollout(u0, n_steps, cond, spatial_cond,
                                         include_init)
        with self._serving():
            pred = self._tensor(u0)
            cond, spatial_cond = self._tensor(cond), self._tensor(spatial_cond)
            pos = self._pos(pred.shape[0])
            u0, frames = pred, []
            for _ in range(n_steps):
                pred = self._apply(pred, cond, pos, spatial_cond)
                frames.append(pred)
            return _frames(frames, u0, include_init)

    # ------------------------------------------------------------------
    def _captured_rollout(self, u0, n_steps, cond, spatial_cond,
                          include_init):
        if self.device.type != "cuda":
            raise RuntimeError("captured=True replays a CUDA graph: it needs "
                               "an engine on a CUDA device")
        inputs = [self._tensor(a) for a in (u0, cond, spatial_cond)]
        key = (int(n_steps),) + tuple(
            None if t is None else tuple(t.shape) for t in inputs)
        if key not in self._captured:
            self._captured[key] = self._capture(int(n_steps), inputs)
        static, out, graph, _ = self._captured[key]
        for dst, src in zip(static, inputs):
            if dst is not None:
                dst.copy_(src)
        graph.replay()
        return _frames([out], inputs[0], include_init)

    def _capture(self, n_steps, inputs):
        """Capture an ``n_steps`` rollout from static copies of ``inputs``
        (u0, cond, spatial_cond) in one CUDA graph. One eager step first,
        on a side stream: cuDNN times its algorithms there (timing inside a
        capture fails), and the graph structure, the position grid, the DFT
        tables and the GNN's shifted-path constants reach the device, so the
        capture copies nothing from the host. Returns (static inputs,
        static output, graph, what the graph reads that must stay alive)."""
        static = [None if t is None else t.clone() for t in inputs]
        u, cond, sc = static
        with self._serving():
            packs = [m.w_packed for m in self.model.modules()
                     if isinstance(m, SpectralConvND)]
            pos = self._pos(u.shape[0])
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._apply(u, cond, pos, sc)
            torch.cuda.current_stream(self.device).wait_stream(side)
            torch.cuda.synchronize(self.device)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                pred, frames = u, []
                for _ in range(n_steps):
                    pred = self._apply(pred, cond, pos, sc)
                    frames.append(pred)
                out = torch.cat(frames, dim=2)
        return static, out, graph, (packs, pos)

    # ------------------------------------------------------------------
    def export_rollout(self, path, n_steps, example_u0, cond=None,
                       spatial_cond=None, batch_poly=True):
        """Export one bundled step with ``torch.export`` and save it, behind
        the port's magic and a JSON header, as an artifact that rolls out
        ``n_steps`` steps: the weights, each spectral layer's weight pack
        and the position grid are constants of the artifact, and the
        kernels stay custom-op nodes. With ``batch_poly`` the batch is a
        symbolic dimension (an example batch of 1 is traced as 2). Reload
        with :func:`load_exported` on the export's device type. Returns
        ``path``. (``torch.export`` keeps the tensor constants it traced,
        here the spectral packs, alive after the program is freed.) On a
        sharded engine it exports the unsharded step from the replicated
        weights, outside any grid scope: no collective, so any one rank may
        call it."""
        if self._is_gnn():
            raise NotImplementedError(
                "export_rollout supports grid models; the GNN rollout "
                "closes over a batch-size-specialized static graph")
        args = [self._tensor(a) for a in (example_u0, cond, spatial_cond)]
        has_cond, has_sc = args[1] is not None, args[2] is not None
        args = [a for a in args if a is not None]
        if batch_poly and args[0].shape[0] < 2:
            # a traced batch of 1 would be specialised to 1
            args = [torch.cat([a, a]) for a in args]
        step = _ExportStep(self.model, self._pos(1)[0], has_cond, has_sc)
        dynamic = None
        if batch_poly:
            b = torch.export.Dim("b")
            # (u, rest): the step's signature is (u, *rest)
            dynamic = ({0: b}, tuple({0: b} for _ in args[1:]))
        with torch.no_grad(), spatial.scope(None), \
                packed_spectral_weights(self.model), \
                _spectral_weights_hidden(self.model), \
                compute_dtype_scope(self.compute_dtype):
            program = torch.export.export(step, tuple(args),
                                          dynamic_shapes=dynamic)
        payload = io.BytesIO()
        torch.export.save(program, payload)
        header = json.dumps({
            "format": "torch.export",
            "n_steps": int(n_steps),
            "time_window": int(self.tw),
            "has_cond": has_cond,
            "has_spatial_cond": has_sc,
            "u0_shape": ["b" if batch_poly else int(args[0].shape[0]),
                         *map(int, args[0].shape[1:])],
            "pde_name": getattr(self.pde, "name", ""),
            "compute_dtype": str(self.compute_dtype or torch.float32),
            "device": self.device.type,
        }).encode()
        with open(path, "wb") as f:
            f.write(ARTIFACT_MAGIC)
            f.write(len(header).to_bytes(8, "little"))
            f.write(header)
            f.write(payload.getvalue())
        return path


@contextmanager
def _spectral_weights_hidden(model):
    """Unregister each 2D spectral layer's ``weights1``/``weights2`` inside
    the block (their packs serve the no-grad path; a 1D layer reads its
    weights), so an export does not carry
    them as unused parameters beside the packs; restored in order after."""
    layers = [m for m in model.modules()
              if isinstance(m, SpectralConvND) and m.nd == 2]
    saved = [(m, m._parameters.pop("weights1"), m._parameters.pop("weights2"))
             for m in layers]
    try:
        for m in layers:
            m.weights1 = m.weights2 = None
        yield
    finally:
        for m, w1, w2 in saved:
            del m.weights1, m.weights2
            m.weights1, m.weights2 = w1, w2


class _ExportStep(nn.Module):
    """One bundled step of ``model`` for export: the position grid ``pos1``
    [*sp, nd] is a constant broadcast to the (symbolic) batch, and the
    conditioning inputs are positional, present as exported."""

    def __init__(self, model, pos1, has_cond, has_spatial_cond):
        super().__init__()
        self.model = model
        self.pos1 = pos1
        self.has_cond = has_cond
        self.has_spatial_cond = has_spatial_cond

    def forward(self, u, *rest):
        rest = list(rest)
        cond = rest.pop(0) if self.has_cond else None
        sc = rest.pop(0) if self.has_spatial_cond else None
        pos = self.pos1[None].expand((u.shape[0],) + tuple(self.pos1.shape))
        return self.model(u, cond=cond, pos=pos, spatial_cond=sc)


class ExportedSurrogate:
    """A loaded serving artifact (see :meth:`SurrogateEngine.export_rollout`):
    the exported step's module, looped ``n_steps`` times. Only the seed
    window and the conditioning it was exported with are inputs."""

    def __init__(self, module, meta, device):
        self._module = module
        self.meta = meta
        self.device = device
        self.tw = int(meta["time_window"])
        self.n_steps = int(meta["n_steps"])

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def rollout(self, u0, cond=None, spatial_cond=None, include_init=False):
        """[b, c, tw, *sp] seed -> [b, c, n_steps*tw(+tw), *sp] frames."""
        u0 = self._tensor(u0)
        args = [u0]
        for name, val in (("has_cond", cond),
                          ("has_spatial_cond", spatial_cond)):
            if self.meta[name]:
                if val is None:
                    raise ValueError(
                        f"artifact was exported with {name[4:]}; pass it")
                args.append(self._tensor(val))
            elif val is not None:
                raise ValueError(
                    f"artifact was exported without {name[4:]}")
        with torch.inference_mode(), autotuned_convs(deterministic=True):
            pred, frames = u0, []
            for _ in range(self.n_steps):
                pred = self._module(pred, *args[1:])
                frames.append(pred)
            return _frames(frames, u0, include_init)


def load_exported(path, device=None):
    """Load a :meth:`SurrogateEngine.export_rollout` artifact for serving.
    It needs the port's op registrations (imported here) and nothing of the
    model code. ``device`` (default: the export's device type) must be the
    device type it was exported on."""
    # the custom ops the artifact's graph calls
    import nps_tpu_torch.ops.library  # noqa: F401

    with open(path, "rb") as f:
        data = f.read()
    if data[:len(ARTIFACT_MAGIC)] != ARTIFACT_MAGIC:
        raise ValueError(f"{path} is not an nps_tpu_torch export artifact")
    off = len(ARTIFACT_MAGIC)
    hlen = int.from_bytes(data[off:off + 8], "little")
    off += 8
    meta = json.loads(data[off:off + hlen].decode())
    device = torch.device(device or meta["device"])
    if device.type != meta["device"]:
        raise ValueError(f"the artifact was exported on {meta['device']}; "
                         f"it cannot be loaded on {device.type}")
    device = resolve_device(device)
    program = torch.export.load(io.BytesIO(data[off + hlen:]))
    return ExportedSurrogate(program.module(), meta, device)
