"""Autoregressive pushforward trainer (counterpart of
``nps_tpu/train/pushforward.py``).

- ``train_step``: the unroll depth ramps with ``epoch // lr_step_interval``
  up to ``config.unrolling`` and is drawn uniformly below that; each batch
  element gets a random start step; ``unrolled`` model steps run under
  ``torch.no_grad()``, feeding predictions back as inputs with BC
  extraction, injection and min clipping between steps; then one step with
  gradients, loss sqrt(MSE_sum), backward and an optimizer update. With
  ``config.pushforward_fast`` the no-grad applies (and nothing else) run
  inside ``models.config.fast_forward_scope``: the exact GELU becomes the
  tanh form there (on the card K2's tanh epilogue); the graded apply,
  ``test_step``, ``simulate`` and the serving engine never see it.
- ``test_step``: one-step losses at every tw-strided start, the unrolled
  rollout loss (normalised by the spatial cell count and the rollout
  length) and the numerical-baseline loss.
- ``simulate``: the rollout API, from ``nr_gt_steps * tw`` ground-truth
  frames to ``t_res`` in tw-strided steps.

All three run in the trainer's compute dtype (``config.compute_dtype``):
under bf16 the pushforward, the graded apply and the backward run their
activations in bf16; the batch stays f32 (``_floats``), and the loss is
taken in f32 on the physics wrapper's f32 output, as in the JAX package.

The step's phases are named profiler ranges (``train_step/pushforward``,
``/forward``, ``/backward``, ``/optimizer``), which ``python -m
nps_tpu_torch.trace_step --train`` reads; outside a profiler they cost a
few microseconds per step.

Randomness comes from two ``torch.Generator``s seeded from the config's
seed: the depth choice and the start steps; ``train_step`` also takes an
injected ``unrolled`` and ``steps0``. The JAX package's compile-ahead,
``_jit_cache`` and ``dynamic_unroll`` machinery has no counterpart: PyTorch
runs each depth eagerly, with nothing to compile, so the config's
``dynamic_unroll`` is accepted and not read.

Variable-time data (``D.sim1d_var_t``) comes as 7-tuples whose last entry
is the elements' time lengths: ``train_step`` takes a min-cropped batch and
its depth from the batch sampler (``loader.batch_sampler.get_t_batch``);
``test_step`` takes a max-padded batch and multiplies the prediction and
the labels by a mask of the valid frames, built from the lengths, before
every loss (the divisor stays the padded rollout length, as upstream).

Under data parallelism (``TrainInterface.data_parallel``) each rank holds
its slice of the global batch, and the step is the global batch's, as the
JAX step on a global array is: the depth is drawn from the shared generator
on every rank alike, the start steps are drawn for the whole global batch
and each rank takes its slice, the loss is sqrt of the world's sum of
squares (:func:`~nps_tpu_torch.parallel.global_sum`, whose backward leaves
each rank its share of the gradient, which the optimizer's all-reduce
sums), and ``test_step`` sums every rank's losses over the global batch.
Under spatial parallelism (``TrainInterface.grid``) the ranks of one x
group hold the same elements (the draws are the data slice's: ``rank`` and
``world`` are the data index and extent) and their own rows of every field;
each model apply runs inside the trainer's ``model_scope``; the loss and
every evaluation value are sums over cells, so the world's sum adds the
x ranks' shares; ``test_step``'s frames are gathered over the x group, then
over the data slices; ``simulate`` rolls out this rank's rows of the whole
inputs it is given and returns the whole result on every rank (the losses
summed over the x group, the frames gathered along the rows). The MP-GNN
and the 1D models run whole on each x rank, their sums over the data group
as under the other regimes. Under tensor, pipeline and expert parallelism the
ranks of one axis group hold the same elements and compute the same loss
and evaluation, so those sum over the data group only
(``TrainInterface.global_sum``); every model apply, the no-grad pushforward
and ``simulate``'s included, runs inside ``model_scope`` (pipelined,
sharded or split over the experts); the MP-GNN refuses pipeline
parallelism.

GNN models (``M.AR_TB_GNN``) take the same steps: at the model boundary the
grid window goes to node space and back (two reshapes) over a static graph
structure built once per (grid, batch size) on the host and kept on the
device; a grid of other content under the same key rebuilds it.
"""

import math

import numpy as np
import torch
from torch.profiler import record_function

from nps_tpu_torch import parallel
from nps_tpu_torch.common import graph as G
from nps_tpu_torch.common.interfaces import D, M
from nps_tpu_torch.models.config import fast_forward_scope
from nps_tpu_torch.train.base import TrainInterface, in_compute_dtype
from nps_tpu_torch.utils.process_output import process_step
from nps_tpu_torch.utils.seed import get_seed


def window(u, steps, tw, mode):
    """Per-element time windows of u [b, c, t, *sp] at ``steps`` [b]
    (ints): 'data' -> [step-tw, step), 'labels' -> [step, step+tw), 'both'
    -> both."""
    lo, n = {"data": (-tw, tw), "labels": (0, tw), "both": (-tw, 2 * tw)}[mode]
    out = torch.stack([u[i, :, s + lo:s + lo + n]
                       for i, s in enumerate(steps.tolist())])
    if mode == "both":
        return out[:, :, :tw], out[:, :, tw:]
    return out


def frame_mask(u, lengths, max_len=None):
    """1 on the valid frames of each element of u [b, c, t, *sp] and 0 on
    its padding, from the elements' time lengths [b] (at most ``max_len``),
    in u's type; the JAX package builds the same mask on the device."""
    lengths = torch.as_tensor(lengths, device=u.device)
    if max_len is not None:
        lengths = lengths.clamp(max=max_len)
    frames = torch.arange(u.shape[2], device=u.device)
    return (frames.view(1, 1, -1, *[1] * (u.ndim - 3))
            < lengths.view(-1, *[1] * (u.ndim - 1))).to(u.dtype)


def _opt(x):
    """None for an empty placeholder ([b, 0])."""
    return None if (x is None or x.numel() == 0) else x


class AutoregressivePushforwardTrainer(TrainInterface):
    data_interface = [D.sim1d, D.sim2d, D.sim1d_var_t]
    model_interface = [M.AR_TB, M.AR_TB_GNN]

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.tw = self.config.time_window
        self.t_res = self.config.base_resolution[0]
        if not hasattr(self.config, "process_settings"):
            self.config.process_settings = {}
        seed = get_seed()
        self.depth_rng = torch.Generator().manual_seed(seed)
        self.start_rng = torch.Generator().manual_seed(seed + 1)
        self.neighbors = getattr(self.config, "neighbors", 3)
        self._graph_cache = {}
        self._graph_hash = {}

    def _rng_states(self):
        return {"depth": self.depth_rng.get_state(),
                "start": self.start_rng.get_state()}

    def _set_rng_states(self, states):
        if states:
            self.depth_rng.set_state(states["depth"])
            self.start_rng.set_state(states["start"])

    def _variable_time(self):
        return self.data.data_interface == D.sim1d_var_t

    def _is_gnn(self):
        return self.model.model_interface == M.AR_TB_GNN

    def _ensure_graph_static(self, x, batch_size):
        """GNN models: build the static (edges, pos, batch, grid_meta)
        structure for the dataset grid ``x`` [b, *sp, nd] once per (spatial
        shape, batch size), on the device. Checked against the grid's
        content: a same-shape grid with other coordinates rebuilds it."""
        if not self._is_gnn():
            return
        x0 = x[0].detach().cpu().numpy()
        key = (tuple(x0.shape[:-1]), int(batch_size))
        chash = hash(x0.astype(np.float64).tobytes())
        if self._graph_hash.get(key) == chash:
            return
        self._graph_cache[key] = G.structure_on(
            x.device, self.data.pde, x0, self.neighbors, int(batch_size))
        self._graph_hash[key] = chash

    def _apply(self, data, cond, bc, x, t_cond, spatial_cond):
        with self.model_scope(x):
            if self._is_gnn():
                structure = self._graph_cache[(tuple(data.shape[3:]),
                                               data.shape[0])]
                return G.apply_on_grid(self.model, data, structure,
                                       cond=cond, bc=bc, pos=x,
                                       t_cond=t_cond,
                                       spatial_cond=spatial_cond)
            return self.model(data, cond=cond, bc=bc, pos=x, t_cond=t_cond,
                              spatial_cond=spatial_cond)

    def _process(self, *args, **kwargs):
        return process_step(self.data.pde, self.model.model_interface, *args,
                            process_settings=self.config.process_settings,
                            **kwargs)

    @staticmethod
    def _floats(batch):
        """The batch in f32 (a device cache may hold a narrower type)."""
        return tuple(t.float() if t.is_floating_point() else t for t in batch)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    @in_compute_dtype
    def train_step(self, batch, epoch, batch_idx, loader=None, unrolled=None,
                   steps0=None):
        """One pushforward step and optimizer update; returns (loss, None),
        the global batch's loss under data parallelism. ``unrolled`` and
        ``steps0`` [b] (this rank's elements) override the drawn depth and
        start steps. A variable-time batch takes its depth from ``loader``'s
        batch sampler (0 without a loader)."""
        if self._variable_time():
            *batch, _lengths = batch
            if unrolled is None:
                unrolled = (loader.batch_sampler.get_t_batch(batch_idx)
                            if loader is not None else 0)
        u_base, u_super, x, cond, t_cond, spatial_cond = self._floats(batch)
        t_res, b, tw = int(u_super.shape[2]), int(u_super.shape[0]), self.tw
        if unrolled is None:
            max_unrolling = min(epoch // self.config.lr_step_interval,
                                self.config.unrolling)
            unrolled = int(torch.randint(max_unrolling + 1, (1,),
                                         generator=self.depth_rng))
        hi = t_res - tw - tw * unrolled + 1
        if hi <= tw:
            raise ValueError(
                f"trajectory too short to train at unroll depth {unrolled}: "
                f"t_res={t_res} needs at least tw*(unrolled+2)="
                f"{tw * (unrolled + 2)} (tw={tw})")
        if steps0 is None:
            # the global batch's draws; this rank's elements are its slice
            steps0 = torch.randint(tw, hi, (b * self.world,),
                                   generator=self.start_rng)
            steps0 = steps0[self.rank * b:(self.rank + 1) * b]
        steps = torch.as_tensor(steps0, dtype=torch.long).cpu()
        cond_, t_cond_, sc_ = _opt(cond), _opt(t_cond), _opt(spatial_cond)
        self._ensure_graph_static(x, b)

        def t_window(steps):
            return (window(t_cond_, steps, tw, "labels")
                    if t_cond_ is not None else None)

        # with trainer.pushforward_fast the no-grad applies take cheaper
        # numerics (the tanh GELU): their output is only the next window's
        # input, never a gradient path
        fast = bool(getattr(self.config, "pushforward_fast", False))
        with torch.no_grad(), record_function("train_step/pushforward"):
            data, labels = window(u_super, steps, tw, "both")
            _, bc = self._process(data, data, labels, get_bc=True,
                                  set_bc=False, set_min=False)
            for _ in range(unrolled):
                with fast_forward_scope(fast):
                    pred = self._apply(data, cond_, bc, x, t_window(steps),
                                       sc_)
                labels_prev = labels
                steps = steps + tw
                labels = window(u_super, steps, tw, "labels")
                data, bc = self._process(pred, labels_prev, labels,
                                         get_bc=True, set_bc=True,
                                         set_min=True)

        self.optimizer.zero_grad(set_to_none=True)
        with record_function("train_step/forward"):
            pred = self._apply(data, cond_, bc, x, t_window(steps), sc_)
            pred, _ = self._process(pred, labels, None, get_bc=False,
                                    set_bc=True, set_min=True)
            sq = self.criterion(pred, labels)
            if self.data_parallel:
                # the root is taken of the global batch's sum of squares
                sq = self.global_sum(sq)
            loss = torch.sqrt(sq)
        with record_function("train_step/backward"):
            loss.backward()
        with record_function("train_step/optimizer"):
            self.optimizer.step()
        return loss.detach(), None

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    @in_compute_dtype
    @torch.no_grad()
    def test_step(self, batch, batch_idx, use_train_loss_calc=False,
                  include_data=False, max_test_len=None):
        if use_train_loss_calc:
            raise RuntimeError(
                "use_train_loss_calc=True is unexpected: test_step is "
                "implemented")
        lengths = None
        if self._variable_time():
            *batch, lengths = batch
        u_base, u_super, x, cond, t_cond, spatial_cond = self._floats(batch)
        t_res = int(u_super.shape[2])
        if max_test_len is not None:
            t_res = min(max_test_len, t_res)
        mask = (None if lengths is None
                else frame_mask(u_super, lengths, max_test_len))
        b, tw = int(u_super.shape[0]), self.tw
        steps_list = list(range(tw, t_res - tw + 1, tw))
        if not steps_list:
            raise ValueError(
                f"evaluation needs at least one (input, label) window pair: "
                f"t_res={t_res} < 2*time_window={2 * tw}. Use a dataset with "
                f"nt >= 2*time_window or lower --time_window.")
        cond_, t_cond_, sc_ = _opt(cond), _opt(t_cond), _opt(spatial_cond)
        self._ensure_graph_static(x, b)
        crit = self.criterion

        step_losses = []
        for step in steps_list:
            data = u_super[:, :, step - tw:step]
            labels = u_super[:, :, step:step + tw]
            _, bc = self._process(data, data, labels, get_bc=True,
                                  set_bc=False, set_min=False)
            tc = t_cond_[:, :, step:step + tw] if t_cond_ is not None else None
            pred = self._apply(data, cond_, bc, x, tc, sc_)
            if mask is not None:
                window_mask = mask[:, :, step:step + tw]
                pred, labels = pred * window_mask, labels * window_mask
            pred, _ = self._process(pred, labels, None, get_bc=False,
                                    set_bc=True, set_min=True)
            step_losses.append(crit(pred, labels) / b)
        step_losses = torch.stack(step_losses)

        sim = self._simulate(u_super, cond_, x, t_cond_, sc_,
                             nr_gt_steps=self.config.nr_gt_steps, t_res=t_res,
                             compute_loss=True, include_data=include_data,
                             use_bc=True, clip_min=True, divide_by_t=True,
                             batch_size=b, u_mask=mask)
        unrolled_sum = torch.sum(sim["losses"])

        base_sum = torch.zeros((), device=u_super.device)
        if _opt(u_base) is not None:
            spatial_cells = math.prod(self.config.base_resolution[1:])
            starts = range(tw * self.config.nr_gt_steps, t_res - tw + 1, tw)
            base = [crit(u_super[:, :, s:s + tw], u_base[:, :, s:s + tw])
                    / spatial_cells / b for s in starts]
            base_sum = torch.sum(torch.stack(base)) / max(tw * len(base), 1)

        vals = torch.cat([torch.stack([unrolled_sum, base_sum,
                                       step_losses.mean()]),
                          step_losses])
        if self.data_parallel:
            # each value is a sum over the elements (and, split, over this
            # rank's cells) over b: the world's sums over the global batch
            vals = self.global_sum(vals * b) / (b * self.world)
        vals = vals.tolist()
        info = {"Unrolled base losses": vals[1],
                "Unrolled forward losses": vals[0],
                "Mean per-step loss": vals[2]}
        for s, v in zip(steps_list, vals[3:]):
            info[f"Step {s}, mean loss"] = v
        if include_data:
            pred0 = u_super[:, :, tw * self.config.nr_gt_steps - tw:
                            tw * self.config.nr_gt_steps]
            gather = (parallel.gather_rows if self.grid is None
                      else self.grid.gather_frames)
            data_pred = gather(torch.cat([pred0, *sim["preds"]], dim=2))
            data_gt = gather(torch.cat([pred0, *sim["labels"]], dim=2))
            return vals[0], info, (data_gt.cpu().numpy(),
                                   data_pred.cpu().numpy(),
                                   [{} for _ in range(len(data_gt))])
        return vals[0], info

    def _simulate(self, u, cond, x, t_cond, spatial_cond, nr_gt_steps, t_res,
                  compute_loss, include_data, use_bc, clip_min, divide_by_t,
                  batch_size, u_bc=None, u_mask=None):
        """The rollout loop shared by test_step and simulate: a dict of
        ``losses`` [n_steps] and, with include_data, ``preds`` and
        ``labels`` (lists of [b, c, tw, *sp] windows)."""
        tw = self.tw
        spatial_cells = math.prod(self.config.base_resolution[1:])
        steps_list = list(range(tw * nr_gt_steps, t_res - tw + 1, tw))
        if not steps_list:
            raise ValueError(
                f"simulate() needs at least one rollout window: t_res="
                f"{t_res} < {nr_gt_steps + 1}*time_window (tw={tw}, "
                f"nr_gt_steps={nr_gt_steps}). Use a longer trajectory or "
                f"lower --time_window.")
        if u_bc is None:
            u_bc = u
        self._ensure_graph_static(x, batch_size)
        pred = u[:, :, tw * nr_gt_steps - tw: tw * nr_gt_steps]
        bc_prev = u_bc[:, :, tw * nr_gt_steps - tw: tw * nr_gt_steps]
        losses, preds, labels_seq = [], [], []
        for s in steps_list:
            labels = u[:, :, s:s + tw] if compute_loss else None
            tc = t_cond[:, :, s:s + tw] if t_cond is not None else None
            if use_bc:
                bc_next = u_bc[:, :, s:s + tw]
                _, bc = self._process(pred, bc_prev, bc_next, get_bc=True,
                                      set_bc=False, set_min=False)
            else:
                bc, bc_next = None, bc_prev
            pred = self._apply(pred, cond, bc, x, tc, spatial_cond)
            if u_mask is not None and compute_loss:
                mask = u_mask[:, :, s:s + tw]
                pred, labels = pred * mask, labels * mask
            if use_bc:
                pred, _ = self._process(pred, bc_next, None, get_bc=False,
                                        set_bc=True, set_min=False)
            if clip_min:
                pred, _ = self._process(pred, None, None, get_bc=False,
                                        set_bc=False, set_min=True)
            if compute_loss:
                losses.append(self.criterion(pred, labels) / spatial_cells
                              / batch_size)
                labels_seq.append(labels)
            if include_data:
                preds.append(pred)
            bc_prev = bc_next
        result = {"preds": preds, "labels": labels_seq}
        if compute_loss:
            losses = torch.stack(losses)
            result["losses"] = (losses / (tw * len(steps_list))
                                if divide_by_t else losses)
        return result

    @in_compute_dtype
    def simulate(self, u, conditioning, x, compute_loss, include_data,
                 nr_gt_steps, t_res, t_conditioning=None,
                 spatial_conditioning=None, clip_min=True, use_bc=True,
                 u_bc=None, u_mask=None, divide_by_t=True):
        """Rollout API on numpy inputs; returns numpy as the JAX package's:
        losses (a list), (losses, (gt, pred)) or pred. On a row-split
        trainer every rank takes the whole inputs, rolls out its rows, and
        returns the whole result: the losses summed over the x group, the
        frames gathered along the rows."""
        tw = self.tw
        if compute_loss and u.shape[2] < t_res:
            raise ValueError("Cannot compute loss if no ground-truth "
                             "simulation is provided for the full rollout")
        if u.shape[2] < nr_gt_steps * tw:
            raise ValueError("The data is shorter than nr_gt_steps*tw")
        if u_mask is not None and not compute_loss:
            raise ValueError("Mask supplied but compute_loss=False!")
        if not compute_loss and not include_data:
            raise ValueError(
                "simulate() with compute_loss=False and include_data=False "
                "returns nothing; request at least one output")

        def dev(a):
            if a is None:
                return None
            return _opt(torch.as_tensor(np.asarray(a, np.float32),
                                        device=self.device))

        u, x, sc = dev(u), dev(x), dev(spatial_conditioning)
        u_bc, u_mask = dev(u_bc), dev(u_mask)
        split = self.grid is not None and self.grid.split
        if split:
            # this rank's rows of every field (the vectors whole)
            u, u_bc, x, _, _, sc = self.grid.shard_batch(
                (u, u_bc, x, None, None, sc))
            u_mask = self.grid.shard_batch((u_mask,))[0]
        with torch.no_grad():
            res = self._simulate(
                u, dev(conditioning), x, dev(t_conditioning), sc,
                nr_gt_steps=nr_gt_steps, t_res=t_res,
                compute_loss=compute_loss, include_data=include_data,
                use_bc=use_bc, clip_min=clip_min, divide_by_t=divide_by_t,
                batch_size=int(u.shape[0]), u_bc=u_bc, u_mask=u_mask)
            losses = None
            if compute_loss:
                losses = res["losses"]
                if split:
                    # each rank's losses are sums over its rows' cells
                    axis = self.grid.axis
                    parallel.all_reduce_([losses], group=axis.group,
                                         size=axis.size)
                losses = list(losses.cpu().numpy())
            if not include_data:
                return losses
            pred0 = u[:, :, tw * nr_gt_steps - tw: tw * nr_gt_steps]
            whole = self.grid.gather_x if split else (lambda t: t)
            data_pred = whole(torch.cat([pred0, *res["preds"]], dim=2)
                              ).cpu().numpy()
            if not compute_loss:
                return data_pred
            data_gt = whole(torch.cat([pred0, *res["labels"]], dim=2)
                            ).cpu().numpy()
        return losses, (data_gt, data_pred)
