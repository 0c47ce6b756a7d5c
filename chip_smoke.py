#!/usr/bin/env python3
"""Drive the PyTorch port (``nps_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out DIR]

Phases, each printing one JSON line; any failure exits non-zero:

1. device  - the card's name and power limit (nvidia-smi);
2. build   - nvcc builds the kernels from nps_tpu_torch/csrc/ (sm_90a);
3. kernels - each kernel against its plain PyTorch version on the same
             inputs at the main path's shapes, TF32 off: error, kernel time,
             plain-version time, one PyTorch library call's time as a
             yardstick, and the least time the card could take (bound);
             for gn1_gelu_fwd also a device copy of its input; for both
             forward kernels the host cost per call of the wrapper and of
             its custom op (toy shapes, alternated twice). All
             times are device time: 20 calls captured in one CUDA graph,
             replayed and timed with CUDA events, so the wrapper's host cost
             is not in them;
4. slice   - the full-width cfg_twophase_ufno model (3 blocks x 192
             features, 10 modes, 96x64 grid, time window 25) built by
             SurrogateEngine.from_config on the card, random weights from
             the seed, serves three 19-bundled-step rollouts of batch 4
             (the rate is their median); checks shape, finiteness, each
             rollout's kernel launch counts, and one step
             against the same step run by the port on the CPU (with a
             module-by-module comparison of that step by forward hooks on
             both devices, and the step again with cuDNN's algorithm
             timing off and deterministic algorithms on); then serves the
             same rollouts captured in one CUDA graph (the rate is the
             median of three replays) against the eager output (1e-6),
             with the launches counted at capture; then records the shapes
             gn1_gelu_fwd sees in one step and times those calls (graph
             replay) beside their summed bound;
5. train   - the same model built by the training CLI's
             get_config_static and trained on the card: a synthetic
             split from the port's generator (20
             simulations of 501 frames on the 96x64 grid, one channel: the
             one cut, --dataset.c_filter=[0]), 2 epochs at the config's
             batch 16 with a 19-bundled-step validation rollout, best-model
             save and a checkpoint (stdout to train_ufno.log in --out);
             then train steps at injected depths 0
             and 8 timed (median of 5 after a warm-up, host clock around
             synchronised steps) with their launch counts and peak memory;
             one depth-1 step at batch 2 against the same step run by the
             port on the CPU (loss and every gradient); and both kernel ops
             (GNGeluFn, SpectralConv2dFn), output and gradients, at every
             input shape one train step at batch 16 gave them, against
             autograd through their plain versions;
5a. dp     - the same U-FNO trained with data parallelism and ZeRO-1
             (nps_tpu_torch.parallel): two ranks sharing the card over
             gloo (NCCL refuses two ranks on one device), each this script
             run with --dp-worker, joined by the package's
             init_distributed, the trainer the CLI builds with
             data_parallel and zero1, global batch 16, 8 a rank from the
             multi-process loader: one step at depths 0 and 8 from the
             weights and start steps of the single-process batch-16 step
             on the card, loss (1e-5) and every gradient (1e-4) against
             it, launches per rank, step ms (two ranks sharing one card:
             no scaling figure), peak memory and optimizer-state bytes
             per rank with and without ZeRO-1, and the parameters after
             Adam with and without it (1e-6; cuDNN's deterministic
             algorithms); the evaluation of the batch (test_step over
             the whole trajectory, frames gathered over the ranks)
             against the single process's from the same weights: per-step
             losses (1e-5) and the first rollout window's frames (1e-4),
             with every window's error and the unrolled loss, and the
             same of the ranks and of the single process on the ranks'
             halves (their shapes) against it and against each other; a
             rank that fails or hangs fails the phase and its peer is
             killed; beside the ranks, a world of one over NCCL through
             the training CLI (--trainer.distributed=auto, WORLD_SIZE=1,
             data_parallel and zero1), one epoch (stdout to
             train_dp_nccl.log and dp_rank*.log in --out);
5b. pushforward_fast - the same U-FNO trained with
             --trainer.pushforward_fast=true: a depth-0 step whose loss
             equals the flag-off step's bit for bit (same weights, batch
             and start steps), a depth-8 step timed (median of 3) whose
             no-grad applies launch K2 with the tanh GELU (act 2, read
             from the wrappers' per-activation counters) and whose graded
             apply the config's erf one, and K2's f32 tanh forward at the
             twophase GroupNorm shapes against its plain version,
             beside its bound, its plain version and one library call;
6. family  - the other five twophase families at full width, one line
             each: cfg_twophase_drn (Dilated ResNet, 2 blocks x 128
             features, kernel 5; no hand kernel), cfg_twophase_unet
             (U-Net, 32 features, ch_mults [2, 2, 1, 2]; 44 GN+GELU calls
             per apply), cfg_twophase_ufno_fno (an FNO and a U-FNO block
             of 192 features, 10 modes; 16 GN+GELU and 2 spectral calls),
             cfg_twophase_gnn (MP-GNN, 6 blocks x 128 features over the
             24-offset grid graph; no hand kernel) and cfg_twophase_moe
             (the mixture of spectral experts, 3 blocks x 4 experts x 192
             features, 10 modes, ~181 M parameters; 12 spectral calls per
             apply, one an expert, at the U-FNO's shapes). Each goes
             through the same serving (eager and captured) and training
             code as the U-FNO's phases (family_serve, family_train), with
             one training epoch and the median of 3 timed steps per depth;
             then the MP-GNN in bf16 (gnn_bf16 line): one serving step and
             one depth-1 train step at batch 2 on the card against the
             CPU in bf16 at the bf16 bar (the CPU in f32 the reference),
             and its depth-0 train step timed at batch 16;
7. ns512   - cfg_ns512_ufno (512x512, 3 blocks x 128 features, 20x20
             modes, tanh GELU, bf16) at full width from its config over a
             split from the port's generator (4 simulations of 151 frames,
             one channel) read through PDE2DDataset: 3 rollouts of the 3
             bundled steps after the first window at batch 8 (each
             simulation's first window and the one after it), eager and
             captured (against eager, 1e-6), peak memory, one step in f32
             against bf16 (nRMSE, a 5e-2 sanity bound); a narrow model (1
             block x 16 features, f32, batch 2) whose step launches both
             new kernel variants, against the port on the CPU (1e-4); the
             serving step's tanh F.gelu calls by caller (the encoder's,
             the decoder's, each block's own and its U-Net's final one:
             none after a K2 call, whose tanh epilogue replaces them);
             then the large-plane spectral conv at [8, 132, 512, 512] ->
             128 in bf16 and f32, and GN+GELU (its tanh GELU) at the
             largest and smallest ns512 GroupNorm inputs (bf16 and f32),
             each against its plain version, twice for the same bits,
             beside its bound, its plain version and one PyTorch call;
8. ns512_train - the same config trained on that split through the
             training CLI's get_config_static as shipped (bf16, f32
             parameters and Adam, per-block remat with the
             save_conv_outputs policy, its own data_parallel=True, which
             one process runs as the single-device step): one epoch (one step: the
             train split holds 2 simulations; stdout to train_ns512.log in
             --out), then steps at batch 8 timed at depths 0 and 4 (median
             of 3 after a warm-up) with peak memory, their launch counts
             (the remat recomputes every K1 and K2 forward of the graded
             apply) and no call of a plain version; a depth-0 step without
             remat (its peak memory, or its out-of-memory error); one step
             of the same weights in f32 against bf16 at batch 2 (a 5e-2
             sanity bound on the loss); the narrow model (1 x 16, f32) at
             depth 1 card against CPU; one more depth-0 step whose tanh
             F.gelu calls are counted by caller as in serving (the remat
             recomputes the U-Net final ones) and whose 66 gn1_gelu_bwd
             calls are recorded (none may copy dy) and timed together
             beside their summed bound; then the large-plane input
             gradient at the ns512 call in bf16 and f32, spectral_dw2d at
             its 800 modes and gn1_gelu_bwd in bf16 at the largest and
             smallest ns512 GroupNorm inputs with the GELU off and tanh,
             each against its plain version, twice for the same bits,
             beside its bound, its plain version and one PyTorch call;
             and the grad_accum run (trainer.grad_accum=2, the JAX
             trainer's optax.MultiSteps): two depth-0 mini-steps at batch
             8 and full width, each with a depth-0 step's launches, the
             parameters unchanged after the first and moved after the
             second; effective steps of batch 16 (two mini-steps) timed
             (median of 3 after a warm-up) with their peak memory beside
             the batch-8 depth-0 step's; the narrow model (1 x 16, f32) at
             grad_accum=2 through one boundary card against CPU (losses
             1e-4, the mean gradient 5e-3, the parameters' nRMSE 1e-4);
8a. sp     - spatial parallelism (nps_tpu_torch.parallel.spatial): every
             split stage (the K1 row split's spectral_split_dft, _mix and
             its adjoint, _inv; K2's gn1_split_sums, _apply, _bwd_sums,
             _bwd_apply) against its plain version at the twophase U-FNO's
             and cfg_ns512_ufno's local shapes at K = 2, beside its bound
             and the plain version's time; then two worlds of two ranks
             sharing the card over gloo (each rank this script run with
             --sp-worker, logs sp_rank*.log and sp_others_rank*.log in
             --out; the second world takes simulate(), the engine and the
             other families, so that the two run side by side), each a
             (data, x) grid of 1 x 2, the trainer the CLI builds with
             data_parallel and spatial_parallel=2: the full-width
             twophase U-FNO (f32, TF32
             off, batch 16, 48 of the 96 rows a rank) from the dp phase's
             weights and starts: the first window's forward (1e-4), one
             step at depths 0 and 8 (loss 1e-5, every gradient 1e-4,
             every split entry launched), the evaluation of the batch
             (per-step losses 1e-5, first window 1e-4); the engine's
             shard(2) rollout of 8 bundled steps against one device's
             (nRMSE 1e-3; captured=True refused); simulate() on the
             row-split trainer (4 elements, 5 bundled steps, the whole
             inputs given) against one process's (losses and frames,
             1e-3); then the other families at full width against one
             process on the card (steps: loss 1e-5, every gradient 1e-4;
             every split entry of the family launched, every other one
             not): cfg_twophase_moe (3 x 4 experts x 192, its gate on the
             static conditioning; the ep phase's weights and reference)
             and the time-conditioned U-FNO (K1 at 204 channels, K2 at
             396) at depths 0 and 1, the U-Net with attention on its two
             deepest levels and in the middle at depths 0 and 1 and its
             shard(2) rollout of 8 bundled steps (nRMSE 1e-3), the
             MP-GNN and cfg_var1d_fno at depth 0, whole on each x rank
             (no row fetched, nothing summed over the x group, no split
             entry, the trainer's log line saying so), then
             export_rollout from a sharded engine of the U-FNO (rank 0
             from shard(2), rank 1 from shard(0), each alone: no
             collective), its artifact loaded and rolled out 8 bundled
             steps on the card against the unsharded eager rollout
             (rtol 1e-5, atol 1e-6), its K1 and K2 launches the path's
             (the sp line's ranks' "export"); last, after the
             grid phases' ranks have ended, cfg_ns512_ufno as shipped
             with spatial_parallel=2 (bf16, remat, batch 8, 256 of 512
             rows a rank), one depth-0 step against the single-process
             bf16 step (loss 8e-3, gradients' nRMSE 5e-2), each rank's
             peak memory beside the one process's, then the MP-GNN (whole
             on each rank at batch 16: ~29 GiB a rank); step ms ("two ranks
             sharing one card": no scaling figure), halo and sum bytes and
             launches per rank printed on their own line; the split
             stages are held at the time-conditioned shapes too
             ([16, 204, 48, 64] and [16, 396, 50, 68]);
8b. tp, ep, pp - tensor, expert and pipeline parallelism
             (nps_tpu_torch.parallel.tensor, .expert, .pipeline): ranks
             sharing the card over gloo (each this script run with
             --grid-worker, logs {tp,ep,pp}_rank*.log in --out), a (data,
             axis) grid of D = 1 x K, the trainer the CLI builds with
             data_parallel and the regime, full width, f32, TF32 off,
             batch 16: tp the twophase U-FNO at K = 2 (each rank holds
             half the output channels of every split weight; K1 on 96 of
             the 192 channels, K2 on whole activations), a step at
             depth 0 and the evaluation of 2 elements over 50
             frames (every split layer's output goes through host memory
             on gloo); ep cfg_twophase_moe at K = 2 (2 of the 4
             experts of each block a rank), steps at depths 0 and 1; pp
             the U-FNO at K = 3 (one block a stage) with 4
             microbatches, steps at depths 0 and 2; then each rank's
             model cases (GRID_CASES), each against one process on the
             card: tp the time-conditioned U-FNO (K1 at 204 input
             channels to the rank's 96) at depths 0 and 1, from the sp
             world's reference, the MP-GNN (6 x 128, whole activations
             on each rank) at batch 4, depth 0, and, on the ep world's
             two ranks once their ep cases end, the U-Net with attention
             on its two deepest levels and in the middle at depth 0
             (from the sp world's reference) and
             the 3D FNO and Dilated ResNet (32 features, 3 blocks,
             64x64x32, batch 2) at depths 0 and 1, then the 3D FNO, DRN
             and MoE under spatial parallelism (regime "sp": a (data, x)
             grid of 1 x 2, 32 of the 64 rows a rank, the 3D spectral
             conv split at its row contraction, the DRN's dilated
             circular halos fetched; depths 0 and 1; halos or sums in
             every step); ep cfg_twophase_moe
             with a BC encoder of 8 outputs over the split's
             t_conditioning and a 3D MoE (4 experts a block), depths 0
             and 1; pp the U-FNO
             with attention on its mini U-Nets' lower level and middle
             (depths 0 and 1), a list of 3 attention U-Nets, one a stage
             (depth 0), and the 3D FNO and DRN (2 microbatches); the
             three phases' 7 ranks run at once, with the sp phase's 4
             (one batch of ranks, "sp_grids" on the seconds line). Each
             against one process on the card from the same weights and
             starts: the loss (1e-5) and every gradient,
             gathered whole (1e-4); each rank's K1 and K2 launches (its
             wrappers' counts, and the forward kernels counted by name with
             torch.profiler in a forward apply) equal to its share of the
             path; both kernel ops against their plain versions at every
             shape the ranks gave them, and timed at the cases' new ones
             (K1 at the tcond tp share and at the ep MoE's 204 input
             channels, K2 at the attention U-FNO's largest pp input:
             the kernels line's tp_ufno_tcond_shape, ep_moe_bc_shape and
             pp_ufno_attn_shape); per rank the step ms ("ranks
             sharing one card": no scaling figure), parameter and
             optimizer-state bytes beside one process's, peak memory and
             collective bytes, printed on their own line, and a line per
             rank and model case;
8c. var1d  - cfg_var1d_fno, the variable-time 1D FNO, at full width (2
             blocks x 64 features, 8 modes, time window 5, batch 8) on a
             ragged split from the port's generator at its config's size
             (64 simulations of 40-100 frames on 32 points): one epoch
             through the training CLI on the card (stdout to
             train_var1d.log in --out), train steps timed at depths 0, 1
             and 2 (median of 5 after a warm-up), one masked max-pad
             evaluation (loss 1e-4) and one train step (loss 1e-4,
             gradients 5e-3) card against CPU, and the engine's 19-step
             rollout of batch 8, eager and captured (against eager, 1e-6).
             It runs neither K1 nor K2 (its spectral conv is
             torch.einsum, as JAX's is XLA's): every launch count stays 0,
             and the kernels line gains no entry for it;
8d. p13a   - the model pieces no shipped config uses, at full width, f32,
             TF32 off, on the twophase split (one line each): the
             time-conditioned U-FNO (cfg_twophase_ufno_tcond: a BC
             encoder of 8 outputs over the split's 2-channel x 501-frame
             t_conditioning memmap, named by --dataset.t_conditioning, so
             K1 takes 204 channels and the U-Net blocks' K2 8 more)
             trained by the family path (one epoch at batch 16 with its
             evaluation's test_step, steps at depths 0 and 8, a depth-1
             step card vs CPU, both kernel ops at every train-step shape),
             then K1 and K2 (forward and backward) timed and held at its
             largest new shapes (kept in the kernels line under
             tcond_shape); the engine serves no BC encoder, as the JAX
             package's cannot; cfg_twophase_unet with attention on its two
             deepest levels and in the middle, served (eager, captured)
             and trained by the family paths; the 3D FNO and Dilated
             ResNet (32 features, 2 blocks, 8x8x8 modes, 64x64x32, time
             window 4, batch 2; no shipped config): forward and one grad
             step card vs CPU (forward and loss 1e-4, gradients 5e-3),
             with their times;
9. export  - the slice's U-FNO exported on the card (torch.export of one
             bundled step, symbolic batch, 19 steps; the kernels stay the
             custom ops nps_torch::gn1_gelu_fwd and
             nps_torch::spectral_dft2d_fwd), reloaded, serving batches of
             4 and 2 against the engine (rtol 1e-5, atol 1e-6): rate,
             launches, artifact size, export and load seconds;
10. profile - after every timed phase, as a profiler session slows the
             host's launch path for the rest of the process: per family an eager rollout and
             a replay of the captured one, and the artifact's rollouts,
             each under torch.profiler: K1 and K2 counted by kernel name
             (a CUDA graph's replay makes no Python launch, so the
             wrappers' counters cannot see it) and the device-busy share;
             the var1d rollout's too (no K1 or K2 may appear); then K2's
             backward at every input the train steps gave it, its kernels
             and memsets by name against the calls each route took, and
             each route's launches a call (the kernels line's
             launches_per_call);
11. stages - the large-plane spectral conv at the ns512 call, forward
             and input gradient, bf16 and f32: each of its kernels' device
             time (torch.profiler) and a call's span, failing unless the
             DFT stages its type and alignment choose ran (the tensor-core
             stages in bf16); kept in the kernels line under "stages".

In the kernels phase the spectral conv runs at the serving batch (4) and
the train batch (16), and at the train batch to 96 channels (a model
rank's share under tp: under ``tp_shape`` in its record), and the backward
ops join the forward kernels at the
train batch: the gn1_gelu_bwd kernels (gn1_bwd_ticket at the train shape;
the three-kernel route, for samples under BWD_THREE_BELOW bytes, at the
U-Net's 9x5 planes) and the spectral conv's backward (the
adjoint launch spectral_dft2d_bwd on dy with the forward's saved weight
pack, and the weight-gradient kernel spectral_dw2d), each against autograd
through its plain version; the backward is called on the autograd node its
forward built, and its two launches are also timed and checked apart,
against their plain versions (spectral_dw2d also for the same bits on two
calls), and the backward with FiLM in both modes (dx, dW and dfilm
against plain autograd; its input-gradient launch, which runs the FiLM
stage before the adjoint mix, also alone). Their "ms" is graph replay of
the op itself; the plain and library
backwards run through the autograd engine, which a graph captured apart
from its forward cannot replay, so theirs are eager calls between two CUDA
events.

Then each phase's seconds on one line, a ``{"kernels": [...]}`` line and,
last, the ``{"ok": true, ...}`` line. Exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repo. Longer outputs
(ptxas reports) go to ``--out``, and every JSON line of the run to
``lines.jsonl`` there too.
"""

import argparse
import collections
import contextlib
import io
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

BATCH, TW, NX1, NX2, N_STEPS, ROLLOUTS = 4, 25, 96, 64, 19, 3
HIDDEN, BLOCKS, MODES = 192, 3, 10
N_STATIC, N_SPATIAL = 2, 2
# H100 SXM published peaks (NVIDIA's data sheet): HBM bytes/s and
# f32 flop/s outside the tensor cores (the kernels use none)
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
# GN+GELU flops per element: sum, square-add, subtract, scale, shift, and
# ~3 for GELU around erff (counted as one)
GN_FLOPS_PER_ELEMENT = 8
GN_SHAPES = [(BATCH, 2 * HIDDEN + N_STATIC + N_SPATIAL, 100, 68),
             (BATCH, HIDDEN, 47, 31)]
SPEC_CI = HIDDEN + N_STATIC + N_SPATIAL
REL_TOL_F32 = 1e-5    # kernel vs plain, f32: sums in another order
REL_TOL_BF16 = 1e-2   # bf16 output: one rounding of an 8-bit mantissa
# the bf16 bar's floor (ROADMAP "How a part is held"): bf16 against its
# reference within max(2 d, BF16_FLOOR), d the reference's own bf16-vs-f32
# deviation
BF16_FLOOR = 8e-3
REL_TOL_STEP = 1e-4   # card vs CPU step, the ROADMAP forward bar
REL_TOL_GRAD = 1e-4   # backward kernels vs plain autograd, f32: more terms
REL_TOL_STEP_GRAD = 5e-3  # card vs CPU gradients, the ROADMAP gradient bar
CAPTURED_TOL = 1e-6   # captured rollout vs eager: the same kernels
EXPORT_RTOL, EXPORT_ATOL = 1e-5, 1e-6   # artifact vs engine (JAX's bar)
# the train step's largest GroupNorm input at the config's batch 16
GN_BWD_SHAPE = (16, 2 * HIDDEN + N_STATIC + N_SPATIAL, 100, 68)
# GN+GELU backward flops per element: x-hat, the pre-activation, GELU' around
# one exp (~12), the two sums, then the same again and dx in the apply pass
GN_BWD_FLOPS_PER_ELEMENT = 40
# cfg_twophase_unet's largest and smallest GroupNorm inputs at batch 16:
# the top of the up path, where the transposed convs have grown the grid
# past 96x64, and the 9x5 (odd h*w) inside the middle level's valid convs
GN_UNET_SHAPES = [(16, 132, 130, 98), (16, 256, 9, 5)]
TRAIN_BATCH, TRAIN_SIMS, TRAIN_NT, TRAIN_EPOCHS = 16, 20, 501, 2
# the spectral conv's input: serving at batch 4, training at batch 16 (its
# mix runs two 8-sample tiles there); the backward runs only in training
SPEC_SHAPES = [(b, SPEC_CI, NX1, NX2) for b in (BATCH, TRAIN_BATCH)]
TRAIN_DEPTHS = (0, 8)
# the five twophase families at full width: per model apply, the GN+GELU
# calls (every U-Net ResidualBlock norm) and the spectral-conv calls (one
# per FNO layer), then the training epochs and the timed steps per depth;
# the Dilated ResNet and the MP-GNN run neither kernel (cuDNN convs; dense
# layers and shifted-grid messages in plain PyTorch); the mixture of
# experts runs K1 once an expert (3 blocks x 4). The
# U-FNO is the main path: its serving and training lines are the "slice"
# and "train" phases, the others' the "family" phase
FAMILIES = {"ufno": (48, 3, TRAIN_EPOCHS, 5), "drn": (0, 0, 1, 3),
            "unet": (44, 0, 1, 3), "ufno_fno": (16, 2, 1, 3),
            "gnn": (0, 0, 1, 3), "moe": (0, 12, 1, 3)}
# the forward launches a graded apply makes again in its backward where the
# family's processor rematerializes its blocks (models/common.py:
# remat_block): the FNO processor of cfg_twophase_ufno_fno (on by default,
# as in the JAX package) recomputes its one spectral call; the DRN
# recomputes too, with no hand kernel; the U-FNO configs of twophase and
# the mixture of experts leave remat off
RECOMPUTED = {"ufno_fno": {"spectral_dft2d_fwd": 1}}
# the pieces no shipped config uses (P13a), on the same split and paths as
# the families: (config, overrides, the FAMILIES fields). The time-
# conditioned U-FNO (cfg_twophase_ufno + a BC encoder of the split's
# TCOND_CHANNELS x TRAIN_NT t_conditioning memmap: 8 outputs, so K1 takes
# 196 + 8 channels and the U-Net blocks' K2 8 more) trains only, since the
# engine serves no BC encoder (as the JAX package's); the U-Net with
# attention on its two deepest levels and in the middle is served and
# trained
TCOND_CHANNELS = 2
P13A = {"ufno_tcond": (
            "nps_tpu_torch/configs/train/cfg_twophase_ufno_tcond.py",
            ["--dataset.t_conditioning=t_conditioning"], (48, 3, 1, 3)),
        "unet_attn": (
            "nps_tpu_torch/configs/train/cfg_twophase_unet.py",
            ["--model.is_attn=[False,False,True,True]",
             "--model.mid_attn=true"], (44, 0, 1, 3))}
# the 3D models (no shipped config): FNO and Dilated ResNet, hidden 32, 2
# blocks, 8x8x8 modes, a 64x64x32 grid, time window 4, batch 2
D3_GRID, D3_TW, D3_BATCH, D3_HIDDEN, D3_MODES = (64, 64, 32), 4, 2, 32, 8
# their card-vs-CPU gradients: about ten times the worst reading of a sound
# run on the H100 (1.006e-4, the 3D FNO's decoder weight, a sum over
# 262,144 cells; the DRN's worst 1.26e-5)
REL_TOL_3D_GRAD = 1e-3
# cfg_ns512_ufno: 512x512, 3 blocks x 128 features, 20x20 modes, bf16,
# batch 8; the spectral conv's input [8, 132, 512, 512] -> 128 (128
# features + 2 static + 2 spatial conditioning channels). A split of NS_SIMS
# generated simulations of NS_NT frames: 151, not the config's 101, since a
# train step at the ramp's end (depth 4, tw 25) needs tw * (4 + 2) = 150
# frames (the 101 of the config admit depth 2 at most, in nps_tpu too). The
# serving batch is their first window and the window after it; a rollout is
# the 3 bundled steps that follow the first window (frames 25-99)
NS_CFG = "nps_tpu_torch/configs/train/cfg_ns512_ufno.py"
NS_BATCH, NS_N, NS_NT, NS_TW, NS_SIMS, NS_STEPS = 8, 512, 151, 25, 4, 3
NS_HIDDEN, NS_BLOCKS, NS_MODES = 128, 3, 20   # one spectral conv a block
NS_SPEC_SHAPE = (NS_BATCH, NS_HIDDEN + 4, NS_N, NS_N)
# the narrow model through the new kernel paths, card against CPU: 1 block
# x 16 features at 512x512, 20 modes, batch 2, f32
NS_NARROW = ["--model.hidden_features=16", "--model.hidden_blocks=1"]
# bf16 against f32 on the card, one step of the first NS_F32_BATCH samples:
# a sanity bound on the nRMSE (with random weights the largest deviation
# sits in the decoder's delta, at bf16's own level: PERF.md section 6)
NS_F32_TOL, NS_F32_BATCH = 5e-2, 2
# ns512 training (the ns512_train phase): the config's batch 8 in bf16 with
# per-block remat (save_conv_outputs), one short epoch, then steps timed at
# depths 0 and 4 (the ramp's end, `unrolling`); the narrow model's depth-1
# step card against CPU at batch 2 in f32; one step of the same full-width
# weights in f32 against bf16 at batch 2, a sanity bound on the loss (bf16
# rounds each activation to 8 mantissa bits; the loss is a sum of squares
# over the whole output, where those deviations average out far below it)
NS_TRAIN_DEPTHS, NS_TRAIN_TIMED = (0, 4), 3
NS_TRAIN_F32_TOL = 5e-2
# cfg_var1d_fno (the var1d phase): 2 blocks x 64 features, 8 modes, time
# window 5, batch 8, at the size of its config's docstring: 64 generated
# simulations of 40-100 frames on 32 points (generate_var_t's defaults);
# steps timed at every depth its ramp reaches (unrolling 2); 19 bundled
# serving steps, as the twophase rollouts
V1_CFG = "nps_tpu_torch/configs/train/cfg_var1d_fno.py"
V1_SIMS, V1_NX, V1_T_MIN, V1_T_MAX, V1_TW, V1_BATCH = 64, 32, 40, 100, 5, 8
V1_DEPTHS, V1_TIMED, V1_STEPS = (0, 1, 2), 5, 19
# bf16 dense products on the tensor cores (NVIDIA's data sheet)
PEAK_BF16 = 989e12
# graph replay for calls of about a millisecond and more
FEW_CALLS = dict(calls=5, replays=5, warmup=2)
# GN+GELU's activation, as chip_smoke names it, and the wrappers' keywords
GN_ACT_KW = {"off": dict(gelu=False, approximate="none"),
             "erf": dict(gelu=True, approximate="none"),
             "tanh": dict(gelu=True, approximate="tanh")}
# the tanh F.gelu calls one cfg_ns512_ufno apply keeps, by caller: the
# encoder's two and the decoder's one, and per block the U-FNO's own
# activation and its U-Net's final one (after GroupNorm(8), not fused);
# the 66 ResidualBlock norms take K2's tanh epilogue (their caller,
# unet_modern.py:_norm_act, must not appear)
NS_TANH_PER_APPLY = {"enc_grid.py:forward": 2, "ufno.py:block": NS_BLOCKS,
                     "unet_modern.py:forward": NS_BLOCKS,
                     "dec_grid.py:forward": 1}


def gn_act(gelu, approximate="none"):
    """chip_smoke's name of a GN+GELU call's activation."""
    return "off" if not gelu else ("tanh" if approximate == "tanh"
                                   else "erf")


# the open file main() writes every JSON line to besides stdout
# (lines.jsonl in --out): a runner that keeps only the end of a run's
# output would lose the earlier lines, and the kernels line alone is long
LINES = {"file": None}


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    if LINES["file"] is not None:
        LINES["file"].write(line + "\n")
        LINES["file"].flush()


def rel_err(a, ref):
    return float((a.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def graph_ms(fn, calls=20, replays=10, warmup=3):
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between two CUDA events. Returns
    (ms, None), or (None, why) when the capture is refused; there is no
    fallback to timing eager calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
    except RuntimeError as e:
        return None, f"graph capture refused: {e}"[:300]
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls), None


def event_ms(fn, calls=10, warmup=2):
    """Device time per call of ``fn`` from eager calls between two CUDA
    events (for work a separately captured graph cannot replay)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def host_us(fn, calls=2000, warmup=50):
    """Host microseconds per call of ``fn`` over ``calls`` calls ended by
    one synchronise: at a toy size, where the device work is shorter than
    the host's, this is the launch path's cost."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def dispatch_us(gen):
    """What the no-grad path pays per kernel call for going through the
    custom op: host us per call of each forward wrapper and of its op
    (``torch.ops.nps_torch.*``), alternated twice, at toy shapes."""
    import torch

    from nps_tpu_torch.ops import group_norm as gn
    from nps_tpu_torch.ops import spectral as sp

    x = torch.randn((2, 36, 8, 8), device="cuda", generator=gen)
    w, b = torch.ones(36, device="cuda"), torch.zeros(36, device="cuda")
    xs = torch.randn((2, 20, 24, 16), device="cuda", generator=gen)
    wp = sp.pack_weights_2d([torch.rand((2, 20, 12, 4, 5), device="cuda",
                                        generator=gen) for _ in range(2)])
    calls = {
        "gn1_gelu_fwd": (lambda: gn.gn1_gelu_fwd(x, w, b, True, gn.EPS),
                         lambda: torch.ops.nps_torch.gn1_gelu_fwd(
                             x, w, b, True, gn.EPS)),
        "spectral_dft2d_fwd": (
            lambda: sp.spectral_dft2d_fwd(xs, wp, (4, 5)),
            lambda: torch.ops.nps_torch.spectral_dft2d_fwd(xs, wp, 4, 5,
                                                           None, 1))}
    out = {}
    with torch.inference_mode():
        for name, (wrapper, op) in calls.items():
            runs = [(host_us(wrapper), host_us(op)) for _ in range(2)]
            out[name] = {"wrapper_us": [r[0] for r in runs],
                         "op_us": [r[1] for r in runs],
                         "shape": list((x if name.startswith("gn")
                                        else xs).shape)}
    return out


def timed(rec, fn, key, **graph):
    """Put ``fn``'s graph-replay time under ``rec[key]`` (None and the
    reason under ``rec["timing_refused"]`` if capture is refused);
    ``graph``: :func:`graph_ms`'s calls, replays and warm-up."""
    ms, why = graph_ms(fn, **graph)
    rec[key] = ms
    if why:
        rec.setdefault("timing_refused", {})[key] = why


def gn_bound(shapes, itemsize=4):
    """Least time of gn1_gelu_fwd over ``shapes``: x read once, y written
    once, GN_FLOPS_PER_ELEMENT flops per element."""
    n = sum(math.prod(s) for s in shapes)
    return bound(2 * itemsize * n, GN_FLOPS_PER_ELEMENT * n)


def spectral_flops(b, ci, co, n1, n2, m1, m2):
    """Flops of one truncated-DFT spectral conv, [b, ci] -> [b, co], in the
    order that needs fewest: the forward along y (the half spectrum) first,
    the inverse along x (rows) first, so that only m2 column modes meet a
    whole plane each way."""
    k = 2 * m1
    return (b * ci * (n1 * n2 * m2 * 4 + n1 * k * m2 * 8)   # forward DFT
            + k * m2 * b * ci * co * 8                      # complex mix
            + b * co * (k * n1 * m2 * 8 + n1 * n2 * m2 * 4))  # inverse DFT


def bound(nbytes, flops, peak_ops=PEAK_F32):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_ops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    emit({"phase": "device", "nvidia_smi": line,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return line


def phase_build(out_dir):
    from nps_tpu_torch import kernels

    t0 = time.perf_counter()
    so = kernels.build()
    kernels.library()
    seconds = time.perf_counter() - t0
    logs = sorted(kernels.BUILD_DIR.glob("*.log"))
    with open(out_dir / "ptxas.log", "w") as f:
        for log in logs:
            f.write(f"==> {log.name}\n{log.read_text()}\n")
    emit({"phase": "build", "seconds": round(seconds, 3), "library": so.name,
          "sources": sorted(p.name for p in kernels.CSRC.glob("*.cu"))})


def phase_kernels(gen):
    results = {}

    # ---- gn1_gelu_fwd (K2) -------------------------------------------------
    for shape in GN_SHAPES:
        rec = gn_fwd_record(gen, shape)
        results.setdefault("gn1_gelu_fwd", rec)   # the largest shape

    # ---- spectral_dft2d_fwd (K1) --------------------------------------------
    recs = [spectral_fwd_record(gen, shape) for shape in SPEC_SHAPES]
    results["spectral_dft2d_fwd"] = recs[0]   # the serving shape's
    # a model rank's share under tensor parallelism: co = HIDDEN / TP_K
    results["spectral_dft2d_fwd"]["tp_shape"] = {
        k: v for k, v in spectral_fwd_record(
            gen, SPEC_SHAPES[-1], HIDDEN // TP_K).items()
        if k not in ("phase", "name")}
    dispatch = dispatch_us(gen)
    for name in ("gn1_gelu_fwd", "spectral_dft2d_fwd"):
        results[name]["dispatch_host_us"] = dispatch[name]
    results["gn1_gelu_bwd"] = gn_bwd_record(gen)
    results["gn1_gelu_bwd_three"] = gn_bwd_record(gen, GN_UNET_SHAPES[1],
                                                  "three")
    results["spectral_dft2d_bwd"], results["spectral_dw2d"] = (
        spectral_bwd_records(gen))
    results["spectral_dft2d_bwd"]["film"] = [
        spectral_film_bwd_record(gen, mode) for mode in (0, 1)]
    unet = [gn_shape_record(gen, shape) for shape in GN_UNET_SHAPES]
    for name in ("gn1_gelu_fwd", "gn1_gelu_bwd"):
        results[name]["unet_shapes"] = [
            {"shape": r["shape"], **r[name]} for r in unet]
    return results


def gn_fwd_record(gen, shape):
    """gn1_gelu_fwd at ``shape`` against its plain version (f32 and bf16),
    its device time beside the plain version's, F.group_norm + F.gelu's and
    a device copy of x (a yardstick: the same bytes), and its bound."""
    import torch
    import torch.nn.functional as F

    from nps_tpu_torch.ops import group_norm as gn

    c = shape[1]
    x = torch.randn(shape, device="cuda", generator=gen) * 1.5 + 0.3
    gamma = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=gen)
    beta = 0.1 * torch.randn(c, device="cuda", generator=gen)
    y_k = gn.gn1_gelu_fwd(x, gamma, beta)
    y_p = gn.gn_gelu_plain(x, gamma, beta)
    torch.cuda.synchronize()
    err = rel_err(y_k, y_p)
    xb = x.to(torch.bfloat16)
    err_bf16 = rel_err(gn.gn1_gelu_fwd(xb, gamma, beta),
                       gn.gn_gelu_plain(xb, gamma, beta))
    bound_ms, bound_by = gn_bound([shape])
    rec = {"phase": "kernel", "name": "gn1_gelu_fwd", "shape": shape,
           "rel_err": err, "rel_err_bf16": err_bf16,
           "max_abs_err": float((y_k - y_p).abs().max()),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_how": "x read once + y written once, f32, at 3.35 TB/s"}
    timed(rec, lambda: gn.gn1_gelu_fwd(x, gamma, beta), "ms")
    timed(rec, lambda: gn.gn_gelu_plain(x, gamma, beta), "plain_ms")
    timed(rec, lambda: F.gelu(F.group_norm(x, 1, gamma, beta)),
          "library_ms")
    flat, dst = x.view(-1), torch.empty_like(x).view(-1)
    timed(rec, lambda: dst.copy_(flat), "copy_ms")
    rec["bound_share"] = bound_ms / rec["ms"] if rec["ms"] else None
    emit(rec)
    if not (err < REL_TOL_F32 and err_bf16 < REL_TOL_BF16):
        raise AssertionError(f"gn1_gelu_fwd disagrees at {shape}: "
                             f"f32 {err}, bf16 {err_bf16}")
    return rec


def gn_shape_record(gen, shape):
    """gn1_gelu_fwd and gn1_gelu_bwd at ``shape`` against the plain
    version (the backward against autograd through it), each with its
    device time beside its bound."""
    import torch

    from nps_tpu_torch.ops import group_norm as gn

    c, n = shape[1], math.prod(shape)
    x = torch.randn(shape, device="cuda", generator=gen) * 1.5 + 0.3
    gamma = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=gen)
    beta = 0.1 * torch.randn(c, device="cuda", generator=gen)
    dy = torch.randn(shape, device="cuda", generator=gen)
    y, stats = gn.gn1_gelu_fwd_stats(x, gamma, beta)
    got = gn.gn1_gelu_bwd(x, gamma, beta, stats, dy)
    y_p, _, ref = _grads(gn.gn_gelu_plain, (x, gamma, beta), dy)
    torch.cuda.synchronize()
    fwd = {"rel_err": rel_err(y, y_p)}
    fwd["bound_ms"], fwd["bound_by"] = gn_bound([shape])
    timed(fwd, lambda: gn.gn1_gelu_fwd(x, gamma, beta), "ms")
    bwd = {"rel_err": _errors(got, ref)[0]}
    bwd["bound_ms"], bwd["bound_by"] = bound(3 * 4 * n,
                                             GN_BWD_FLOPS_PER_ELEMENT * n)
    timed(bwd, lambda: gn.gn1_gelu_bwd(x, gamma, beta, stats, dy), "ms")
    for r in (fwd, bwd):
        r["bound_share"] = r["bound_ms"] / r["ms"] if r["ms"] else None
    rec = {"phase": "kernel", "name": "gn1_gelu (U-Net shape)",
           "shape": shape, "gn1_gelu_fwd": fwd, "gn1_gelu_bwd": bwd}
    emit(rec)
    if not (fwd["rel_err"] < REL_TOL_F32 and bwd["rel_err"] < REL_TOL_GRAD):
        raise AssertionError(f"gn1_gelu at {shape}: forward "
                             f"{fwd['rel_err']}, backward {bwd['rel_err']}")
    return rec


def complex_weights(w1, w2):
    """[weights1, weights2] as one complex [ci, co, 2*m1, m2] tensor."""
    import torch

    w = torch.cat([w1, w2], 3)
    return torch.complex(w[0], w[1])


def rfft_conv(x, w_c, modes):
    """The spectral conv as rfft2 + einsum + irfft2, with the weights in
    complex form (:func:`complex_weights`): the library yardstick."""
    import torch

    m1, m2 = modes
    b, _, n1, n2 = x.shape
    co = w_c.shape[1]
    xf = torch.fft.rfft2(x)
    blk = torch.cat([xf[:, :, :m1, :m2], xf[:, :, n1 - m1:, :m2]], dim=2)
    mixed = torch.einsum("bikm,iokm->bokm", blk, w_c)
    out_ft = torch.zeros((b, co, n1, n2 // 2 + 1), dtype=mixed.dtype,
                         device=x.device)
    out_ft[:, :, :m1, :m2] = mixed[:, :, :m1]
    out_ft[:, :, n1 - m1:, :m2] = mixed[:, :, m1:]
    return torch.fft.irfft2(out_ft, s=(n1, n2))


def spectral_fwd_record(gen, shape, co=HIDDEN):
    """spectral_dft2d_fwd at ``shape`` -> ``co`` channels (HIDDEN), with
    and without FiLM, against its plain version; times beside the library
    call's."""
    import torch

    from nps_tpu_torch.ops import spectral as sp

    dev = torch.device("cuda")
    b, ci, n1, n2 = shape
    m1, m2 = MODES, MODES
    x = torch.randn(shape, device=dev, generator=gen)
    ws = [torch.rand((2, ci, co, m1, m2), device=dev, generator=gen)
          / (ci * co) for _ in range(2)]
    packed = sp.pack_weights_2d(ws)
    y_k = sp.spectral_dft2d_fwd(x, packed, (m1, m2))
    y_p = sp.spectral_conv_2d_plain(x, ws, (m1, m2))
    film = torch.randn((b, co, 2 * m1, m2), device=dev, generator=gen)
    err_film = max(rel_err(sp.spectral_dft2d_fwd(x, packed, (m1, m2), film,
                                                 mode),
                           sp.spectral_conv_2d_plain(x, ws, (m1, m2), film,
                                                     mode))
                   for mode in (0, 1))
    torch.cuda.synchronize()
    err = rel_err(y_k, y_p)
    w_c = complex_weights(*ws)
    err_library = rel_err(rfft_conv(x, w_c, (m1, m2)), y_p)
    flops = spectral_flops(b, ci, co, n1, n2, m1, m2)
    nbytes = 4 * (x.numel() + packed.numel() + b * co * n1 * n2)
    bound_ms, bound_by = bound(nbytes, flops)
    rec = {"phase": "kernel", "name": "spectral_dft2d_fwd",
           "shape": [shape, co, [m1, m2]], "rel_err": err,
           "rel_err_film": err_film, "rel_err_library_vs_plain": err_library,
           "max_abs_err": float((y_k - y_p).abs().max()),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_how": f"x + weights + out f32 once at 3.35 TB/s "
                        f"({nbytes} B); {flops} flop at 67 TFLOP/s"}
    timed(rec, lambda: sp.spectral_dft2d_fwd(x, packed, (m1, m2)), "ms")
    timed(rec, lambda: sp.spectral_conv_2d_plain(x, ws, (m1, m2)),
          "plain_ms")
    timed(rec, lambda: rfft_conv(x, w_c, (m1, m2)), "library_ms")
    rec["bound_share"] = bound_ms / rec["ms"] if rec["ms"] else None
    emit(rec)
    if not (err < REL_TOL_F32 and err_film < REL_TOL_F32):
        raise AssertionError(f"spectral_dft2d_fwd disagrees at {shape}: "
                             f"{err}, film {err_film}")
    return rec


def _grads(fn, leaves, dy):
    """(output, autograd graph inputs, gradients) of ``fn`` at copies of
    ``leaves``; the graph is kept for timing its backward again."""
    import torch

    leaves = [t.detach().clone().requires_grad_() for t in leaves]
    y = fn(*leaves)
    return y, leaves, torch.autograd.grad(y, leaves, dy, retain_graph=True)


def _errors(got, ref):
    return (max(rel_err(a, r) for a, r in zip(got, ref)),
            max(float((a - r).abs().max()) for a, r in zip(got, ref)))


def gn_bwd_design(x, dy):
    """gn1_gelu_bwd's route at x and dy (ops/group_norm.py:gn_bwd_route),
    the ticket kernel's plan there, and the route's floor as a model: on
    gn1_bwd_ticket the one-read bound where a sample's x and dy fit L2
    (``l2_fit``), else x and dy read twice less the L2's bytes a sample
    (the tail of the sums read again first); on the three-kernel route x
    and dy read twice."""
    import torch

    from nps_tpu_torch.ops import group_norm as gn

    route = gn.gn_bwd_route(x)
    vec, plan = gn.gn1_bwd_plan_for(x, dy)
    resident, l2 = gn._bwd_resident(x.device, x.dtype == torch.bfloat16, vec)
    n, size = x.numel(), x.element_size()
    fit = 2 * size * n <= x.shape[0] * l2
    nbytes = 3 * size * n
    if route == "three":
        nbytes += 2 * size * n
    elif not fit:
        nbytes += max(0, 2 * size * n - x.shape[0] * l2)
    return {"route": route,
            "plan": dict(plan._asdict(), vec=vec, resident=resident,
                         l2_bytes=l2),
            "l2_fit": fit, "floor_ms": nbytes / PEAK_BYTES * 1e3}


# the design model's keys (gn_bwd_design), kept in the phase records and
# out of the kernels line, which holds measured numbers and bound_ms only
GN_BWD_MODEL_KEYS = ("plan", "l2_fit", "floor_ms")


def gn_bwd_measured(rec):
    """``rec`` without the design model's keys."""
    return {k: v for k, v in rec.items() if k not in GN_BWD_MODEL_KEYS}


def gn_bwd_record(gen, shape=GN_BWD_SHAPE, route="ticket"):
    """gn1_gelu_bwd at ``shape`` (the train step's largest GroupNorm input;
    the U-Net's smallest for the three-kernel route) against autograd
    through the plain version and through F.group_norm + F.gelu; it must
    take ``route`` there."""
    import torch
    import torch.nn.functional as F

    from nps_tpu_torch.ops import group_norm as gn

    c = shape[1]
    x = torch.randn(shape, device="cuda", generator=gen) * 1.5 + 0.3
    gamma = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=gen)
    beta = 0.1 * torch.randn(c, device="cuda", generator=gen)
    dy = torch.randn(shape, device="cuda", generator=gen)
    y_k, stats = gn.gn1_gelu_fwd_stats(x, gamma, beta)
    got = gn.gn1_gelu_bwd(x, gamma, beta, stats, dy)
    again = gn.gn1_gelu_bwd(x, gamma, beta, stats, dy)
    y_p, leaves_p, ref = _grads(gn.gn_gelu_plain, (x, gamma, beta), dy)
    torch.cuda.synchronize()
    err, max_abs = _errors(got, ref)
    err_y = rel_err(y_k, y_p)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    n = math.prod(shape)
    bound_ms, bound_by = bound(3 * 4 * n, GN_BWD_FLOPS_PER_ELEMENT * n)
    rec = {"phase": "kernel", "name": "gn1_gelu_bwd", "shape": shape,
           "act": "erf", "rel_err": err, "max_abs_err": max_abs,
           "rel_err_fwd_y": err_y, "same_bits": same,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_how": "x, dy read once + dx written once, f32, at "
                        "3.35 TB/s", **gn_bwd_design(x, dy)}
    timed(rec, lambda: gn.gn1_gelu_bwd(x, gamma, beta, stats, dy), "ms")
    rec["plain_ms"] = event_ms(lambda: torch.autograd.grad(
        y_p, leaves_p, dy, retain_graph=True))
    del y_p, leaves_p
    y_l, leaves_l, _ = _grads(
        lambda x, w, b: F.gelu(F.group_norm(x, 1, w, b)), (x, gamma, beta),
        dy)
    rec["library_ms"] = event_ms(lambda: torch.autograd.grad(
        y_l, leaves_l, dy, retain_graph=True))
    rec["bound_share"] = bound_ms / rec["ms"] if rec["ms"] else None
    emit(rec)
    if not (err < REL_TOL_GRAD and err_y < REL_TOL_F32 and same
            and rec["route"] == route):
        raise AssertionError(f"gn1_gelu_bwd disagrees: {err} (forward y "
                             f"{err_y}), same bits {same}, route "
                             f"{rec['route']}, want {route}")
    return rec


def spectral_bwd_records(gen, shape=SPEC_SHAPES[-1]):
    """SpectralConv2dFn's backward (dx and both weight gradients) at the
    train step's ``shape``, called as autograd calls it on the node its forward
    built (so it reads what the forward saved), against autograd through
    the plain version and through rfft2 + einsum + irfft2; then its two
    launches apart, each against its plain version and beside its bound:
    the adjoint launch (spectral_dft2d_bwd) and the weight gradient
    (spectral_dw2d). Returns both records."""
    import torch

    from nps_tpu_torch.ops import spectral as sp

    b, ci, n1, n2 = shape
    co, m1, m2 = HIDDEN, MODES, MODES
    modes = (m1, m2)
    x = torch.randn(shape, device="cuda", generator=gen)
    ws = [torch.rand((2, ci, co, m1, m2), device="cuda", generator=gen)
          / (ci * co) for _ in range(2)]
    dy = torch.randn((b, co, n1, n2), device="cuda", generator=gen)
    leaves = [t.detach().clone().requires_grad_() for t in (x, *ws)]
    # the output is kept alive with its node: some PyTorch versions free a
    # node's saved tensors with its last output
    y = sp.SpectralConv2dFn.apply(*leaves, modes)
    node = y.grad_fn
    got = node.apply(dy)[:3]
    y_p, leaves_p, ref = _grads(
        lambda x, w1, w2: sp.spectral_conv_2d_plain(x, [w1, w2], modes),
        (x, *ws), dy)
    torch.cuda.synchronize()
    err, max_abs = _errors(got, ref)
    modes_n = 2 * m1 * m2
    w_numel = 2 * ws[0].numel()
    nbytes = 4 * (dy.numel() + w_numel                 # dy, W read
                  + 2 * modes_n * b * ci                # saved spectrum
                  + x.numel() + w_numel)                # dx, dW written
    flops = (spectral_flops(b, co, ci, n1, n2, m1, m2)  # dx: adjoint conv
             + modes_n * b * ci * co * 8)               # dW: complex products
    bound_ms, bound_by = bound(nbytes, flops)
    rec = {"phase": "kernel", "name": "spectral_dft2d_bwd",
           "shape": [shape, co, [m1, m2]], "rel_err": err,
           "max_abs_err": max_abs, "bound_ms": bound_ms,
           "bound_by": bound_by,
           "bound_how": f"dy + weights + saved spectrum read, dx + dW "
                        f"written once, f32, at 3.35 TB/s ({nbytes} B); "
                        f"{flops} flop at 67 TFLOP/s"}
    timed(rec, lambda: node.apply(dy), "ms")
    rec["plain_ms"] = event_ms(lambda: torch.autograd.grad(
        y_p, leaves_p, dy, retain_graph=True))
    del y_p, leaves_p
    y_l, leaves_l, ref_l = _grads(
        lambda x, w1, w2: rfft_conv(x, complex_weights(w1, w2), modes),
        (x, *ws), dy)
    rec["rel_err_library_vs_plain"] = _errors(ref_l, ref)[0]
    rec["library_ms"] = event_ms(lambda: torch.autograd.grad(
        y_l, leaves_l, dy, retain_graph=True))
    del y_l, leaves_l, ref_l
    rec["bound_share"] = bound_ms / rec["ms"] if rec["ms"] else None

    # the adjoint launch on the forward's saved pack
    xr, xi, packed = node.saved_tensors
    adj = sp.spectral_dft2d_bwd(dy, packed, modes)
    adj_err, adj_abs = _errors(adj, sp.spectral_dft2d_bwd_plain(dy, packed,
                                                                modes))
    adj_bytes = 4 * (dy.numel() + packed.numel() + x.numel())
    adj_bound, adj_by = bound(adj_bytes,
                              spectral_flops(b, co, ci, n1, n2, m1, m2))
    rec["adjoint"] = {"rel_err": adj_err, "max_abs_err": adj_abs,
                      "bound_ms": adj_bound, "bound_by": adj_by,
                      "bound_how": f"dy + pack read, dx written once "
                                   f"({adj_bytes} B)"}
    timed(rec["adjoint"], lambda: sp.spectral_dft2d_bwd(dy, packed, modes),
          "ms")
    timed(rec["adjoint"],
          lambda: sp.spectral_dft2d_bwd_plain(dy, packed, modes), "plain_ms")
    rec["adjoint"]["bound_share"] = (adj_bound / rec["adjoint"]["ms"]
                                     if rec["adjoint"]["ms"] else None)
    emit(rec)

    if not (err < REL_TOL_GRAD and adj_err < REL_TOL_F32):
        raise AssertionError(f"spectral_dft2d_bwd disagrees: {err} (adjoint "
                             f"launch {adj_err})")
    # the weight gradient from the saved spectrum and the adjoint's G
    scale = sp.mode_scale(n1, n2, m1, m2, "cuda")
    return rec, dw2d_record(xr, xi, *adj[1:], scale, m1)


def dw2d_record(xr, xi, gr, gi, scale, m1):
    """spectral_dw2d on the spectra X [modes, b, ci] and G [modes, b, co]
    against its plain version, twice for the same bits, timed beside the
    plain version and one torch.einsum over the complex spectra, with its
    bound."""
    import torch

    from nps_tpu_torch.ops import spectral as sp

    modes_n, b, ci = xr.shape
    co = gr.shape[2]
    m2 = modes_n // (2 * m1)
    dw = sp.spectral_dw2d(xr, xi, gr, gi, scale, m1)
    dw_again = sp.spectral_dw2d(xr, xi, gr, gi, scale, m1)
    dw_ref = sp.spectral_weight_grad(xr, xi, gr, gi, scale, m1)
    torch.cuda.synchronize()
    dw_err, dw_abs = _errors(dw, dw_ref)
    w_numel = 2 * dw[0].numel()
    dw_bytes = 4 * (2 * modes_n * b * (ci + co) + w_numel)
    dw_bound, dw_by = bound(dw_bytes, modes_n * b * ci * co * 8)
    rec_dw = {"phase": "kernel", "name": "spectral_dw2d",
              "shape": [[modes_n, b, ci], co, [m1, m2]], "rel_err": dw_err,
              "max_abs_err": dw_abs,
              "same_bits": all(torch.equal(a, c)
                               for a, c in zip(dw, dw_again)),
              "bound_ms": dw_bound, "bound_by": dw_by,
              "bound_how": f"X + G read, dW written once, f32, at 3.35 TB/s "
                           f"({dw_bytes} B)",
              "library_how": "torch.einsum('mbi,mbo->mio') over the complex "
                             "spectra, X conjugated and scaled beforehand; "
                             "its output [modes, ci, co] complex"}
    timed(rec_dw, lambda: sp.spectral_dw2d(xr, xi, gr, gi, scale, m1), "ms")
    timed(rec_dw, lambda: sp.spectral_weight_grad(xr, xi, gr, gi, scale, m1),
          "plain_ms")
    xs = torch.complex(xr, xi).conj() * scale[:, None, None]
    g_c = torch.complex(gr, gi)
    lib = torch.einsum("mbi,mbo->mio", xs, g_c)
    lib = torch.stack([lib.real, lib.imag]).reshape(2, 2 * m1, m2, ci, co)
    lib = lib.permute(0, 3, 4, 1, 2)
    rec_dw["rel_err_library_vs_plain"] = _errors(
        (lib[:, :, :, :m1], lib[:, :, :, m1:]), dw_ref)[0]
    timed(rec_dw, lambda: torch.einsum("mbi,mbo->mio", xs, g_c),
          "library_ms")
    rec_dw["bound_share"] = dw_bound / rec_dw["ms"] if rec_dw["ms"] else None
    emit(rec_dw)
    if not (dw_err < REL_TOL_F32 and rec_dw["same_bits"]):
        raise AssertionError(f"spectral_dw2d disagrees at {[modes_n, b, ci]}"
                             f" -> {co}: {dw_err}, same bits "
                             f"{rec_dw['same_bits']}")
    return rec_dw


def spectral_film_bwd_record(gen, film_mode):
    """SpectralConv2dFn's backward with FiLM at the train step's shape (dx,
    both weight gradients and dfilm), on the node its forward built,
    against autograd through the plain version; then the input-gradient
    launch with FiLM (its FiLM stage film_bwd_kernel before the adjoint
    mix) against its plain version."""
    import torch

    from nps_tpu_torch.ops import spectral as sp

    shape = SPEC_SHAPES[-1]
    b, ci, n1, n2 = shape
    co, m1, m2 = HIDDEN, MODES, MODES
    modes = (m1, m2)
    x = torch.randn(shape, device="cuda", generator=gen)
    ws = [torch.rand((2, ci, co, m1, m2), device="cuda", generator=gen)
          / (ci * co) for _ in range(2)]
    film = torch.randn((b, co, 2 * m1, m2), device="cuda", generator=gen)
    dy = torch.randn((b, co, n1, n2), device="cuda", generator=gen)
    leaves = [t.detach().clone().requires_grad_() for t in (x, *ws, film)]
    y = sp.SpectralConv2dFn.apply(*leaves[:3], modes, leaves[3], film_mode)
    node = y.grad_fn   # y stays alive with its node (see spectral_bwd_records)
    got = node.apply(dy)
    got = [got[0], got[1], got[2], got[4]]
    y_p, leaves_p, ref = _grads(
        lambda x, w1, w2, f: sp.spectral_conv_2d_plain(x, [w1, w2], modes, f,
                                                       film_mode),
        (x, *ws, film), dy)
    torch.cuda.synchronize()
    err, max_abs = _errors(got, ref)
    modes_n = 2 * m1 * m2
    w_numel = 2 * ws[0].numel()
    spec = modes_n * b * co   # one part of the pre-FiLM spectrum, or of G
    nbytes = 4 * (dy.numel() + w_numel + 2 * modes_n * b * ci
                  + 2 * spec + film.numel()               # U and film read
                  + x.numel() + w_numel + film.numel())   # dx, dW, dfilm
    flops = (spectral_flops(b, co, ci, n1, n2, m1, m2)
             + modes_n * b * ci * co * 8 + 6 * spec)
    bound_ms, bound_by = bound(nbytes, flops)
    rec = {"phase": "kernel", "name": "spectral_dft2d_bwd (FiLM)",
           "film_mode": film_mode, "shape": [shape, co, [m1, m2]],
           "rel_err": err, "max_abs_err": max_abs, "bound_ms": bound_ms,
           "bound_by": bound_by,
           "bound_how": f"as spectral_dft2d_bwd, and the pre-FiLM spectrum "
                        f"and film read, dfilm written ({nbytes} B)"}
    timed(rec, lambda: node.apply(dy), "ms")
    rec["plain_ms"] = event_ms(lambda: torch.autograd.grad(
        y_p, leaves_p, dy, retain_graph=True))
    del y_p, leaves_p
    rec["bound_share"] = bound_ms / rec["ms"] if rec["ms"] else None

    # the input-gradient launch with FiLM on what the forward saved
    xr, xi, packed, film_s, ur, ui = node.saved_tensors
    scale = sp.mode_scale(n1, n2, m1, m2, "cuda")
    args = (dy, packed, modes, film_s, film_mode, (ur, ui), scale)
    adj = sp.spectral_dft2d_bwd(*args)
    adj_err, adj_abs = _errors(adj, sp.spectral_dft2d_bwd_plain(*args))
    rec["adjoint"] = {"rel_err": adj_err, "max_abs_err": adj_abs}
    timed(rec["adjoint"], lambda: sp.spectral_dft2d_bwd(*args), "ms")
    emit(rec)
    if not (err < REL_TOL_GRAD and adj_err < REL_TOL_F32):
        raise AssertionError(f"spectral_dft2d_bwd with FiLM (mode "
                             f"{film_mode}) disagrees: {err} (input-gradient "
                             f"launch {adj_err})")
    return {k: rec[k] for k in ("film_mode", "rel_err", "max_abs_err", "ms",
                                "plain_ms", "bound_ms", "bound_by",
                                "bound_share")} | {
        "adjoint_ms": rec["adjoint"]["ms"]}


def gn_step_time(eng, u0, cond, sc):
    """The gn1_gelu_fwd calls of one bundled step: record the shapes the
    wrapper sees, then time the same calls on fresh inputs (graph replay)
    beside their summed bound."""
    import torch

    from nps_tpu_torch.ops import group_norm as gn

    seen = []
    wrapped = gn.gn1_gelu_fwd

    def record(x, weight, bias, gelu=True, eps=gn.EPS, approximate="none"):
        seen.append((tuple(x.shape), x.dtype, gn_act(gelu, approximate)))
        return wrapped(x, weight, bias, gelu, eps, approximate)

    gn.gn1_gelu_fwd = record
    try:
        eng.step(u0, cond=cond, spatial_cond=sc)
    finally:
        gn.gn1_gelu_fwd = wrapped
    calls = []
    for shape, dtype, act in seen:
        x = torch.randn(shape, device="cuda").to(dtype)
        w = torch.ones(shape[1], device="cuda")
        calls.append((x, w, torch.zeros_like(w), GN_ACT_KW[act]))
    ms, why = graph_ms(lambda: [wrapped(*c[:3], **c[3]) for c in calls],
                       calls=5)
    bound_ms, bound_by = gn_bound([s for s, _, _ in seen],
                                  torch.finfo(seen[0][1]).bits // 8)
    counts = {}
    for s, _, _ in seen:
        counts[s] = counts.get(s, 0) + 1
    return {"calls": len(seen),
            "shapes": [[list(s), n] for s, n in sorted(counts.items())],
            "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms if ms else None,
            **({"timing_refused": why} if why else {})}


def _grad_errors(got, ref, floor_frac=1e-5):
    """Per parameter max|d| / max|ref|, a tensor whose gradient is below
    ``floor_frac`` of the model's largest held at that floor (zero in exact
    arithmetic, f32 noise on both sides); the worst one: (err, name). A
    parameter no gradient reaches (an attention block's unused norm) must
    have none on both sides."""
    none = {k for k, r in ref.items() if r is None}
    if none != {k for k, g in got.items() if g is None}:
        return float("inf"), f"no gradient on one side: {sorted(none)}"
    ref = {k: r for k, r in ref.items() if r is not None}
    floor = floor_frac * max(float(r.abs().max()) for r in ref.values())
    return max((float((got[k].cpu() - r).abs().max())
                / max(float(r.abs().max()), floor), k)
               for k, r in ref.items())


@contextlib.contextmanager
def kernel_shapes():
    """Record the distinct inputs the kernels' forward calls see inside the
    block: GN+GELU (shape, activation) and spectral conv (shape, co,
    modes)."""
    from nps_tpu_torch.ops import group_norm as gn
    from nps_tpu_torch.ops import spectral as sp

    seen = {"gn": set(), "spectral": set()}
    gn_fwd, sp_fwd = gn.gn1_gelu_fwd_stats, sp.spectral_dft2d_fwd_spectrum

    def gn_record(x, weight, bias, gelu=True, eps=gn.EPS, approximate="none"):
        seen["gn"].add((tuple(x.shape), gn_act(gelu, approximate)))
        return gn_fwd(x, weight, bias, gelu, eps, approximate)

    def sp_record(x, w_packed, modes, *args, **kwargs):
        seen["spectral"].add((tuple(x.shape), w_packed.shape[3],
                              tuple(modes)))
        return sp_fwd(x, w_packed, modes, *args, **kwargs)

    gn.gn1_gelu_fwd_stats = gn_record
    sp.spectral_dft2d_fwd_spectrum = sp_record
    try:
        yield seen
    finally:
        gn.gn1_gelu_fwd_stats, sp.spectral_dft2d_fwd_spectrum = gn_fwd, sp_fwd


def check_shapes(seen, gen):
    """Both kernel ops, output and gradients, at every input ``seen`` in a
    train step, against autograd through their plain versions on fresh
    inputs: output < REL_TOL_F32, each gradient < REL_TOL_GRAD."""
    import torch

    from nps_tpu_torch.ops import group_norm as gn
    from nps_tpu_torch.ops import spectral as sp

    def compare(fn, plain, leaves, dy):
        y, _, got = _grads(fn, leaves, dy)
        y_p, _, ref = _grads(plain, leaves, dy)
        return {"rel_err_y": rel_err(y, y_p),
                "rel_err_grad": _errors(got, ref)[0]}

    rows = []
    for shape, act in sorted(seen["gn"]):
        c = shape[1]
        x = torch.randn(shape, device="cuda", generator=gen) * 1.5 + 0.3
        gamma = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=gen)
        beta = 0.1 * torch.randn(c, device="cuda", generator=gen)
        dy = torch.randn(shape, device="cuda", generator=gen)
        kw = GN_ACT_KW[act]
        rows.append({"op": "GNGeluFn", "shape": shape, "act": act,
                     **compare(lambda *t: gn.GNGeluFn.apply(
                                   *t, kw["gelu"], gn.EPS, kw["approximate"]),
                               lambda *t: gn.gn_gelu_plain(*t, **kw),
                               (x, gamma, beta), dy)})
    for shape, co, modes in sorted(seen["spectral"]):
        b, ci, n1, n2 = shape
        x = torch.randn(shape, device="cuda", generator=gen)
        ws = [torch.rand((2, ci, co, *modes), device="cuda", generator=gen)
              / (ci * co) for _ in range(2)]
        dy = torch.randn((b, co, n1, n2), device="cuda", generator=gen)
        rows.append({"op": "SpectralConv2dFn", "shape": shape, "co": co,
                     **compare(lambda x, w1, w2: sp.SpectralConv2dFn.apply(
                                   x, w1, w2, modes),
                               lambda x, w1, w2: sp.spectral_conv_2d_plain(
                                   x, [w1, w2], modes),
                               (x, *ws), dy)})
    torch.cuda.synchronize()
    return rows


def make_split(tmp, seed):
    """The synthetic twophase split both training phases read: TRAIN_SIMS
    simulations of TRAIN_NT frames on the full grid, one channel, and a
    ``t_conditioning`` memmap of TCOND_CHANNELS beside them (the P13a
    phase's). Returns the seconds it took."""
    import numpy as np

    from nps_tpu_torch.data.synthetic import generate

    t0 = time.perf_counter()
    generate(f"{tmp}/data/twophase", n_sims=TRAIN_SIMS, n_channels=1,
             nt=TRAIN_NT, nx1=NX1, nx2=NX2, seed=seed)
    # the time conditioning the generator does not write, beside its files
    rng = np.random.default_rng(seed + 11)
    np.save(f"{tmp}/data/twophase/t_conditioning.npy",
            rng.standard_normal((TRAIN_SIMS, TCOND_CHANNELS, TRAIN_NT))
            .astype(np.float32))
    return time.perf_counter() - t0


def build_trainer(cfg, argv, device, trainer_keys=None, updates=None,
                  model=None):
    """The trainer the CLI builds from ``cfg`` and ``argv`` (and
    ``trainer_keys`` set in the parsed config's trainer section: keys such
    as spatial_parallel that cfg_var1d_fno, like its JAX original, does not
    declare; ``updates``, {section: entries}, the entries no flag reaches,
    such as a processor list or a key the config lacks; ``model`` a model
    that replaces the config's, the CLI's ``model_override``), with its
    optimizer and scheduler set."""
    from nps_tpu_torch import train_cli
    from nps_tpu_torch.configs.parse import parse_args

    saved = sys.argv
    try:
        sys.argv = argv
        with contextlib.redirect_stdout(sys.stderr):
            args = parse_args(cfg)
    finally:
        sys.argv = saved
    args["trainer"].update(trainer_keys or {})
    for section, entries in (updates or {}).items():
        args[section].update(entries)
    trainer = train_cli.get_config_static(args, device=device,
                                          model_override=model)[4]
    trainer.set_optimizer(dict(args["optimizer"]))
    trainer.set_lr_scheduler(dict(args["lr_scheduler"]))
    return trainer


def train_argv(tmp, seed, epochs, name):
    return ["chip_smoke", f"--dataset.base_path={tmp}/data",
            "--dataset.c_filter=[0]", f"--seed={seed}",
            f"--trainer.num_epochs={epochs}",
            "--trainer.test_interval=1", "--trainer.print_interval=1",
            f"--experiment_path={tmp}/out", f"--experiment_name={name}"]


def timed_steps(trainer, batch, depth, want, n_timed, batch_size=TRAIN_BATCH):
    """``n_timed`` train steps at an injected depth after a warm-up, each
    with the launch counts set to 0 just before it: host seconds around
    synchronised steps, their median, peak memory and the launch counts
    against ``want``."""
    import torch

    from nps_tpu_torch import kernels

    trainer.train_step(batch, 0, 0, unrolled=depth)  # warm-up
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    seconds, counts = [], []
    for i in range(n_timed):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = trainer.train_step(batch, 0, i + 1, unrolled=depth)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        counts.append(dict(kernels.launches))
    median = sorted(seconds)[len(seconds) // 2]
    return {"step_seconds": seconds, "ms_per_step": 1e3 * median,
            "samples_per_s": batch_size / median,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "resident_gib": resident,
            "loss": float(loss), "launches": counts[0],
            "launches_expected": want,
            "launches_ok": all(c == want for c in counts)}


def step_vs_cpu(cfg, argv, trainer, batch, seed, tw=TW, nt=TRAIN_NT):
    """One depth-1 train step at batch 2 on the card and by the port on the
    CPU, same weights and start steps (windows of ``tw`` frames in ``nt``):
    (record, loss error, worst gradient error)."""
    import torch

    cpu = build_trainer(cfg, argv, "cpu")
    cpu.ensure_initialized()  # builds its optimizer
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               trainer.model.state_dict().items()})
    small = tuple(t[:2] for t in batch)
    steps0 = torch.randint(tw, nt - 2 * tw + 1, (2,),
                           generator=torch.Generator().manual_seed(seed))
    loss_gpu, _ = trainer.train_step(small, 0, 0, unrolled=1, steps0=steps0)
    loss_cpu, _ = cpu.train_step(tuple(t.cpu() for t in small), 0, 0,
                                 unrolled=1, steps0=steps0)
    loss_err = abs(float(loss_gpu) - float(loss_cpu)) / abs(float(loss_cpu))
    grad_err, grad_worst = _grad_errors(
        {k: p.grad for k, p in trainer.model.named_parameters()},
        {k: p.grad for k, p in cpu.model.named_parameters()})
    return ({"depth": 1, "batch": 2, "loss_gpu": float(loss_gpu),
             "loss_cpu": float(loss_cpu), "loss_rel_err": loss_err,
             "grad_rel_err": grad_err, "worst_grad": grad_worst},
            loss_err, grad_err)


def family_cfg(name):
    return f"nps_tpu_torch/configs/train/cfg_twophase_{name}.py"


def family_spec(name):
    """(config, overrides, the FAMILIES fields) of a family or a P13a
    model."""
    if name in P13A:
        return P13A[name]
    return family_cfg(name), [], FAMILIES[name]


def family_launches(gn, spec, applies, backward, recomputed=None):
    """The launch counts of ``applies`` model applies (and one backward)
    of a family with ``gn`` GN+GELU and ``spec`` spectral calls each; the
    backward adds the forward launches its remat runs again
    (``recomputed``, by kernel)."""
    want = {}
    if gn:
        want["gn1_gelu_fwd"] = gn * applies
        if backward:
            want["gn1_gelu_bwd"] = gn
    if spec:
        want["spectral_dft2d_fwd"] = spec * applies
        if backward:
            want["spectral_dft2d_bwd"] = want["spectral_dw2d"] = spec
    if backward:
        for name, n in (recomputed or {}).items():
            want[name] += n
    return want


def twophase_pde():
    from nps_tpu_torch.pde import PDE2D

    return PDE2D(tmin=0.0, tmax=10.0, nt=501, L1=1.0, L2=NX2 / NX1, nx1=NX1,
                 nx2=NX2, x=None, name="twophase", n_cond_static=N_STATIC,
                 n_cond_spatial=N_SPATIAL)


def serving_inputs(seed):
    """The seed window, static and spatial conditioning of a serving batch
    of BATCH, from the seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    u0 = (0.1 + 0.8 * rng.random((BATCH, 1, TW, NX1, NX2))).astype(np.float32)
    cond = rng.random((BATCH, N_STATIC)).astype(np.float32)
    sc = (rng.random((BATCH, N_SPATIAL, NX1, NX2)) > 0.9).astype(np.float32)
    return u0, cond, sc


def profiled_events(fn):
    """Run ``fn`` once under torch.profiler: its device events and the
    window's host seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nps_tpu_torch.trace_step import _device_events

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a first few kernels and a pause before the window, so that the
        # tracer is running when the first kernel of ``fn`` starts
        for _ in range(20):
            torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        time.sleep(0.05)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    return _device_events(prof), window


def profiled(fn):
    """Run ``fn`` once under torch.profiler: the device kernels of the
    port's two forward ops counted by name (K2: gn1_gelu_kernel; K1: its
    mix stage, one per call), the device-busy share of the window, and the
    window's host ms. This counts what a CUDA graph's replay launches, which
    the wrappers' Python counters do not see."""
    from nps_tpu_torch.trace_step import _busy_share

    events, window = profiled_events(fn)
    counts = {"gn1_gelu_fwd": sum("gn1_gelu_kernel" in e.name
                                  for e in events),
              "spectral_dft2d_fwd": sum("mix_kernel" in e.name
                                        for e in events)}
    return ({k: v for k, v in counts.items() if v},
            _busy_share(events, window * 1e6), 1e3 * window)


def _first_sample(t, b):
    """The first sample of a module output whose leading dim is the batch
    (grid tensors) or b node blocks (graph tensors), flattened on the
    host."""
    t = t.detach().float()
    return t.reshape(b, -1)[0].cpu() if t.shape[0] % b == 0 else None


def _hooked(model, nb, fn):
    """Run ``fn`` with a forward hook on every leaf module of ``model``:
    (result, [(module name, first sample of its input, of its output)] in
    execution order)."""
    import torch

    calls, handles = [], []
    for name, m in model.named_modules():
        if next(m.children(), None) is not None:
            continue

        def hook(mod, args, out, name=name):
            if torch.is_tensor(out) and args and torch.is_tensor(args[0]):
                calls.append((name, _first_sample(args[0], nb),
                              _first_sample(out, nb)))
        handles.append(m.register_forward_hook(hook))
    try:
        return fn(), calls
    finally:
        for h in handles:
            h.remove()


def _rel(g, c):
    if g is None or c is None or g.shape != c.shape:
        return None
    return float((g - c).abs().max() / c.abs().max().clamp_min(1e-30))


def diagnose_step(eng, cpu, u0, cond, sc):
    """Where a serving step's card-against-CPU error arises. The step runs
    on the card twice with cuDNN timing any algorithm (the engine's choice
    before it took deterministic ones only), with forward hooks on every
    leaf module, and once on the CPU (its first sample): the modules whose
    output differs between the two
    card runs while their input does not (a nondeterministic algorithm),
    and the module whose card-vs-CPU error jumps most above its input's
    (floored at f32's epsilon). Then the step's error against the CPU with
    the engine's choice (timing among deterministic algorithms) and with
    cuDNN's heuristics and deterministic algorithms."""
    import numpy as np
    import torch

    from nps_tpu_torch.inference import autotuned_convs
    from nps_tpu_torch.models.fno import packed_spectral_weights

    b = u0.shape[0]

    def card_step(timed=True):
        prev = (torch.backends.cudnn.benchmark,
                torch.backends.cudnn.deterministic)
        try:
            if not timed:
                torch.backends.cudnn.benchmark = False
                torch.backends.cudnn.deterministic = True
            with torch.inference_mode(), (autotuned_convs() if timed else
                                          contextlib.nullcontext()), \
                    packed_spectral_weights(eng.model):
                return eng._apply(eng._tensor(u0), eng._tensor(cond),
                                  eng._pos(b), eng._tensor(sc)).cpu().numpy()
        finally:
            (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic) = prev

    run_a, calls_a = _hooked(eng.model, b, card_step)
    run_b, calls_b = _hooked(eng.model, b, card_step)
    step_cpu, calls_c = _hooked(cpu.model, 1, lambda: cpu.step(
        u0[:1], cond=cond[:1], spatial_cond=sc[:1]))

    def vs_cpu(out):
        return float(np.abs(out[:1] - step_cpu).max()
                     / np.abs(step_cpu).max())

    nondet, jumps = [], []
    for (name, a_in, a_out), (_, b_in, b_out), (_, c_in, c_out) in zip(
            calls_a, calls_b, calls_c):
        if _rel(a_in, b_in) == 0.0 and (_rel(a_out, b_out) or 0.0) > 0.0:
            nondet.append({"module": name, "repeat_rel_diff":
                           _rel(a_out, b_out)})
        err, err_in = _rel(a_out, c_out), _rel(a_in, c_in)
        if err is not None and err_in is not None:
            jumps.append({"module": name, "rel_err": err,
                          "input_rel_err": err_in,
                          "jump": err / max(err_in, 1.2e-7)})
    return {
        "any_algorithm": {
            "step_rel_err_vs_cpu": vs_cpu(run_a),
            "repeat_step_rel_diff": float(np.abs(run_a - run_b).max()
                                          / np.abs(run_b).max()),
            "nondeterministic_modules": nondet,
            "modules_compared": len(jumps),
            "largest_jump": max(jumps, key=lambda r: r["jump"], default=None)},
        "deterministic_timed_step_rel_err_vs_cpu": vs_cpu(
            eng.step(u0, cond=cond, spatial_cond=sc)),
        "deterministic_heuristic_step_rel_err_vs_cpu": vs_cpu(
            card_step(timed=False))}


def family_serve(name, seed):
    """Serve ROLLOUTS 19-bundled-step rollouts of batch 4 (after a warm-up
    step; the rate is their median) with the family's full-width model
    built by SurrogateEngine.from_config, random weights from the seed,
    each with the launch counts set to 0 just before it and read just
    after; then the same rollouts captured in one CUDA graph (the first
    call captures; the rate is the median of ROLLOUTS replays), held
    against the eager output (CAPTURED_TOL), with the launches the wrappers
    counted at capture (the warm-up step's and the graph's); one step
    against the same step by the port on the CPU, with diagnose_step's
    module-by-module comparison; where the family runs GN+GELU, the shapes
    gn1_gelu_fwd sees in one step and those calls timed (gn_step_time).
    Returns (record, the first rollout's launches, failures)."""
    import warnings

    import numpy as np
    import torch

    from nps_tpu_torch import kernels
    from nps_tpu_torch.inference import SurrogateEngine

    warnings.filterwarnings("ignore", message="spatial conditioning")
    cfg, over, (gn_calls, spec_calls, *_) = family_spec(name)
    pde = twophase_pde()
    eng = SurrogateEngine.from_config(cfg, overrides=over, pde=pde,
                                      device="cuda")
    eng.init_params(seed=seed)
    u0, cond, sc = serving_inputs(seed)
    step_gpu = eng.step(u0, cond=cond, spatial_cond=sc)   # also warms up
    torch.cuda.reset_peak_memory_stats()
    # the host clock's spread between runs is a few percent
    seconds, launches = [], []
    for _ in range(ROLLOUTS):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.rollout(u0, N_STEPS, cond=cond, spatial_cond=sc)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches.append(dict(kernels.launches))
    median = sorted(seconds)[len(seconds) // 2]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    def captured():
        return eng.rollout(u0, N_STEPS, cond=cond, spatial_cond=sc,
                           captured=True)

    kernels.reset_launches()
    t0 = time.perf_counter()
    out_c = captured()          # eager warm-up step, capture, first replay
    capture_s = time.perf_counter() - t0
    capture_launches = dict(kernels.launches)
    # the wrappers count at capture: the warm-up step's and the graph's
    want_capture = family_launches(gn_calls, spec_calls, N_STEPS + 1, False)
    c_seconds = []
    for _ in range(ROLLOUTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_c = captured()
        torch.cuda.synchronize()
        c_seconds.append(time.perf_counter() - t0)
    c_median = sorted(c_seconds)[len(c_seconds) // 2]
    captured_err = float(np.abs(out_c - out).max() / np.abs(out).max())
    eng.clear_captured()

    cpu = SurrogateEngine.from_config(cfg, overrides=over, pde=pde,
                                      device="cpu")
    cpu.model.load_state_dict({k: v.cpu()
                               for k, v in eng.model.state_dict().items()})
    step_cpu = cpu.step(u0[:1], cond=cond[:1], spatial_cond=sc[:1])
    step_err = float(np.abs(step_gpu[:1] - step_cpu).max()
                     / np.abs(step_cpu).max())
    want = family_launches(gn_calls, spec_calls, N_STEPS, False)
    rec = {"batch": BATCH, "bundled_steps": N_STEPS,
           "parameters": sum(p.numel() for p in eng.model.parameters()),
           "out_shape": list(out.shape),
           "finite": bool(np.isfinite(out).all()),
           "launches": launches[0], "launches_expected": want,
           "step_rel_err_vs_cpu": step_err,
           "step_diagnosis": diagnose_step(eng, cpu, u0, cond, sc),
           "rollout_seconds": seconds,
           "bundled_steps_per_s": N_STEPS / median,
           "samples_steps_per_s": BATCH * N_STEPS / median,
           "peak_mem_gib": peak,
           "captured": {"bundled_steps_per_s": N_STEPS / c_median,
                        "rollout_seconds": c_seconds,
                        "capture_seconds": capture_s,
                        "rel_err_vs_eager": captured_err,
                        "launches_at_capture": capture_launches,
                        "launches_at_capture_expected": want_capture}}
    if gn_calls:
        rec["gn1_gelu_step"] = gn_step_time(eng, u0, cond, sc)
    failures = []
    if tuple(out.shape) != (BATCH, 1, N_STEPS * TW, NX1, NX2):
        failures.append(f"rollout shape {out.shape}")
    if not rec["finite"]:
        failures.append("rollout has non-finite values")
    if any(n != want for n in launches):
        failures.append(f"serving launches {launches} != {want}")
    if not step_err < REL_TOL_STEP:
        failures.append(f"card vs CPU step differs: {step_err}")
    if not captured_err <= CAPTURED_TOL:
        failures.append(f"captured rollout vs eager: {captured_err}")
    if capture_launches != want_capture:
        failures.append(f"launches at capture {capture_launches} != "
                        f"{want_capture}")
    return rec, launches[0], failures


def family_train(name, seed, out_dir, tmp):
    """Train the family's full-width model (built by the CLI's
    get_config_static) its epochs at the config's batch 16 on the split in
    ``tmp`` (stdout to ``train_<name>.log`` in ``out_dir``); time steps at
    the depths TRAIN_DEPTHS (median of its timed steps after a warm-up);
    hold a depth-1 step at batch 2 against the CPU, and both kernel ops at
    every input shape its train step gives them; for a family that runs K1,
    its weight pack's share of the timed steps (weight_pack_record).
    Returns (record, the training run's launches, failures)."""
    import numpy as np
    import torch

    from nps_tpu_torch import kernels
    from nps_tpu_torch.inference import autotuned_convs

    cfg, over, (gn_calls, spec_calls, epochs, n_timed) = family_spec(name)
    argv = [*train_argv(tmp, seed, epochs, f"train_{name}"), *over]
    trainer = build_trainer(cfg, argv, "cuda")
    failures = []
    if trainer.config.batch_size != TRAIN_BATCH:
        failures.append(f"config batch {trainer.config.batch_size}")
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with open(out_dir / f"train_{name}.log", "w") as log, \
            contextlib.redirect_stdout(log):
        train_losses, val_losses, _ = trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = with_routes(kernels)
    save = trainer.config.save_path
    with open(save + "_metrics.jsonl") as f:
        metrics = [json.loads(line) for line in f]
    files = {suffix: Path(save + suffix).exists()
             for suffix in ("_default.pt", "_checkpoint.pt", "_final.pt")}
    n_steps = epochs * len(trainer.get_dataloaders()[0])

    # single steps at injected depths, on one batch of the split
    batch = first_batch(trainer)
    with autotuned_convs():
        with kernel_shapes() as seen, gn_bwd_calls() as bwds:
            trainer.train_step(batch, 0, 0, unrolled=1)  # also a warm-up
        GN_BWD_STEP_CALLS[name] = bwds["calls"]
        # K1: per forward its launches, per backward one adjoint launch on
        # dy and one weight gradient
        steps = {d: timed_steps(trainer, batch, d,
                                family_launches(gn_calls, spec_calls, d + 1,
                                                True, RECOMPUTED.get(name)),
                                n_timed)
                 for d in TRAIN_DEPTHS}
        # one depth-1 step at batch 2, card against CPU
        vs_cpu, loss_err, grad_err = step_vs_cpu(cfg, argv, trainer, batch,
                                                 seed)
    shape_checks = check_shapes(
        seen, torch.Generator(device="cuda").manual_seed(seed + 1))

    # the run's steps are at depth 0 (the ramp admits more from epoch 25)
    per_step = family_launches(gn_calls, spec_calls, 1, True,
                               RECOMPUTED.get(name))
    want_run = {k: v * n_steps for k, v in per_step.items()
                if k.endswith(("_bwd", "_dw2d"))}
    rec = {"batch": TRAIN_BATCH, "epochs": epochs, "train_steps": n_steps,
           "train_seconds": train_s, "train_losses": train_losses,
           "val_losses": val_losses["default"],
           "metrics_lines": len(metrics), "files": files,
           "launches": launches, "launches_expected": want_run,
           "steps": {str(d): v for d, v in steps.items()},
           "step_vs_cpu": vs_cpu, "kernels_at_train_shapes": shape_checks}
    if spec_calls:
        rec["weight_pack"] = weight_pack_record(rec["steps"], trainer.model)
    if not (np.isfinite(train_losses).all()
            and np.isfinite(val_losses["default"]).all()
            and len(val_losses["default"]) == epochs):
        failures.append("training losses are not finite")
    if len(metrics) != epochs or not all(files.values()):
        failures.append(f"missing outputs: {len(metrics)} metric lines, "
                        f"files {files}")
    if any(launches.get(k) != v for k, v in want_run.items()) or not all(
            launches.get(k) for k in per_step if k.endswith("_fwd")):
        failures.append(f"training launches {launches}, want {want_run}")
    if not all(v["launches_ok"] for v in steps.values()):
        failures.append("train-step launch counts differ from the expected")
    ops = {op for op, n in (("GNGeluFn", gn_calls),
                            ("SpectralConv2dFn", spec_calls)) if n}
    bad = [r for r in shape_checks
           if not (r["rel_err_y"] < REL_TOL_F32
                   and r["rel_err_grad"] < REL_TOL_GRAD)]
    if bad or {r["op"] for r in shape_checks} != ops:
        failures.append(f"kernels at the train step's shapes: {bad}, "
                        f"{len(shape_checks)} checked")
    if not (loss_err < REL_TOL_STEP and grad_err < REL_TOL_STEP_GRAD):
        failures.append(f"card vs CPU train step: {vs_cpu}")
    return rec, launches, failures


def with_routes(kernels):
    """The launch counts, with gn1_gelu_bwd's calls by route under
    "gn1_gelu_bwd_ticket" and "gn1_gelu_bwd_three"."""
    return {**kernels.launches,
            **{f"{name}_{route}": n for (name, route), n
               in kernels.route_launches.items()}}


def phase_slice(seed, card):
    """Serve the main path, the U-FNO (family_serve). Returns the first
    eager rollout's launches."""
    import gc

    rec, launches, failures = family_serve("ufno", seed)
    gc.collect()   # the engines and their captured graph, before training
    emit({"phase": "slice", "config": family_cfg("ufno"), **rec,
          "card": card, "tf32": False})
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


def phase_export(seed, card, tmp):
    """Export the full-width U-FNO (the slice's weights) with a symbolic
    batch and N_STEPS steps on the card, reload the artifact and serve
    batches of BATCH and 2: each against the engine's eager rollout
    (EXPORT_RTOL, EXPORT_ATOL), ROLLOUTS timed rollouts (the rate is their
    median) and the wrappers' launch counts of each. Returns the launches
    of the first timed rollout at BATCH, and the artifact's path (kept for
    phase_profile)."""
    import gc
    import os

    import numpy as np
    import torch

    from nps_tpu_torch import kernels
    from nps_tpu_torch.inference import SurrogateEngine, load_exported

    eng = SurrogateEngine.from_config(family_cfg("ufno"), pde=twophase_pde(),
                                      device="cuda")
    eng.init_params(seed=seed)
    u0, cond, sc = serving_inputs(seed)
    path = f"{tmp}/ufno.npst"
    t0 = time.perf_counter()
    eng.export_rollout(path, N_STEPS, u0, cond=cond, spatial_cond=sc)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = load_exported(path)
    load_s = time.perf_counter() - t0
    want = family_launches(*FAMILIES["ufno"][:2], N_STEPS, False)
    rec = {"phase": "export", "config": family_cfg("ufno"),
           "n_steps": N_STEPS, "u0_shape": art.meta["u0_shape"],
           "artifact_bytes": os.path.getsize(path),
           "export_seconds": export_s, "load_seconds": load_s,
           "launches_expected": want, "batches": {}}
    failures, first = [], None
    for b in (BATCH, 2):
        args = dict(cond=cond[:b], spatial_cond=sc[:b])
        ref = eng.rollout(u0[:b], N_STEPS, **args)
        art.rollout(u0[:b], **args)          # warm-up: cuDNN's timing
        seconds, launches = [], []
        for _ in range(ROLLOUTS):
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = art.rollout(u0[:b], **args)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            launches.append(dict(kernels.launches))
        first = first or launches[0]
        median = sorted(seconds)[len(seconds) // 2]
        close = bool(np.allclose(out, ref, rtol=EXPORT_RTOL,
                                 atol=EXPORT_ATOL))
        rec["batches"][str(b)] = {
            "out_shape": list(out.shape), "allclose_to_engine": close,
            "max_abs_err": float(np.abs(out - ref).max()),
            "rollout_seconds": seconds,
            "bundled_steps_per_s": N_STEPS / median,
            "launches": launches[0]}
        if not close or out.shape != ref.shape:
            failures.append(f"artifact vs engine at batch {b}: "
                            f"{rec['batches'][str(b)]['max_abs_err']}")
        if any(n != want for n in launches):
            failures.append(f"artifact launches at batch {b}: {launches}, "
                            f"want {want}")
    emit({**rec, "card": card, "tf32": False})
    del eng, art
    gc.collect()   # the loaded program holds reference cycles
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return first, path


def profiled_counts(fn, want, tries=3):
    """``profiled(fn)`` until its kernel counts equal ``want``, at most
    ``tries`` times: the tracer now and then drops a kernel's record (one
    or two of a rollout's 912 K2 launches in some windows), while a kernel
    that does not run is missing every time. Returns (counts, busy share,
    ms, every attempt's counts)."""
    attempts = []
    for _ in range(tries):
        counts, busy, ms = profiled(fn)
        attempts.append(counts)
        if counts == want:
            break
    return counts, busy, ms, attempts


def gn_bwd_by_name(tries=3):
    """One gn1_gelu_bwd call at every distinct input the train steps gave
    it (GN_BWD_STEP_CALLS), all in one window under torch.profiler
    (profiled_events), taken again up to ``tries`` times while the tracer
    drops records: the device kernels and memsets by name, against the
    calls each route took (the ticket route: one memset and one
    gn1_bwd_ticket a call; the three-kernel route: gn1_bwd_sums,
    gn1_bwd_reduce and gn1_bwd_apply once a call), and the launches a call
    made on each
    route (``launches_per_call``, the counts over the route's calls).
    Returns (record, failures)."""
    import torch

    from nps_tpu_torch.ops import group_norm as gn

    inputs = sorted({c for calls in GN_BWD_STEP_CALLS.values()
                     for c in calls}, key=str)
    args, routes = [], collections.Counter()
    for shape, dtype, act in inputs:
        x = torch.randn(shape, device="cuda").to(dtype)
        dy = torch.randn(shape, device="cuda").to(dtype)
        w = torch.ones(shape[1], device="cuda")
        kw = GN_ACT_KW[act]
        _, stats = gn.gn1_gelu_fwd_stats(x, w, torch.zeros_like(w), **kw)
        args.append(((x, w, torch.zeros_like(w), stats, dy), kw))
        routes[gn.gn_bwd_route(x)] += 1

    def run():
        for a, kw in args:
            gn.gn1_gelu_bwd(*a, **kw)

    kinds = {"ticket": ("gn1_bwd_ticket", "memset"),
             "three": ("gn1_bwd_sums", "gn1_bwd_reduce", "gn1_bwd_apply")}
    want = {k: routes[r] for r, ks in kinds.items() for k in ks}
    run()
    attempts = []
    for _ in range(tries):
        names = collections.Counter(e.name for e in profiled_events(run)[0])
        got = {k: sum(n for name, n in names.items() if k in name.lower())
               for k in want}
        got["other_gn1_bwd"] = sum(
            n for name, n in names.items()
            if "gn1_bwd_" in name and not any(k in name for k in want))
        attempts.append(got)
        if all(got[k] == v for k, v in want.items()):
            break
    del args
    torch.cuda.empty_cache()
    out = {"inputs": [[list(s), str(d)[6:], a] for s, d, a in inputs],
           "calls": dict(routes), "attempts": attempts,
           "launches_per_call": {
               r: {k: got[k] / routes[r] for k in ks}
               for r, ks in kinds.items() if routes[r]}}
    bad = any(got[k] != v for k, v in want.items()) or got["other_gn1_bwd"]
    return out, ([f"gn1_gelu_bwd by kernel name: {got}, want {want}"]
                 if bad else [])


# the profile phase's gn_bwd_by_name record, for the kernels line
GN_BWD_BY_NAME = {}


def phase_profile(seed, card, artifact):
    """Last, since a profiler session leaves the host slower for the rest
    of the process: for every family (its engine built again from the
    seed), the median of ROLLOUTS eager rollouts' rates before its own
    profiled windows (the first family's before any; set beside the family
    line's to show the slowdown), then an eager rollout and a replay of the
    captured one, and at the end the artifact's rollouts at BATCH and 2
    (the file at ``artifact`` loaded again), each under torch.profiler (``profiled_counts``): the K1 and K2 kernels
    counted by name against the launches expected, and the device-busy
    share; then K2's backward kernel by name at every train-step input
    (gn_bwd_by_name). Returns each family's replay counts, by family
    name."""
    import torch

    from nps_tpu_torch.inference import SurrogateEngine, load_exported

    u0, cond, sc = serving_inputs(seed)
    args = dict(cond=cond, spatial_cond=sc)
    rec, replays, failures = {"phase": "profile", "families": {}}, {}, []
    for name in FAMILIES:
        eng = SurrogateEngine.from_config(family_cfg(name),
                                          pde=twophase_pde(), device="cuda")
        eng.init_params(seed=seed)
        want = family_launches(*FAMILIES[name][:2], N_STEPS, False)
        eng.rollout(u0, N_STEPS, **args)                 # warm-up
        eng.rollout(u0, N_STEPS, captured=True, **args)  # capture
        seconds = []
        for _ in range(ROLLOUTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.rollout(u0, N_STEPS, **args)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        fam = {"eager_bundled_steps_per_s":
               N_STEPS / sorted(seconds)[len(seconds) // 2],
               "after_profiler_sessions": list(rec["families"])}
        for mode, fn in (
                ("eager", lambda: eng.rollout(u0, N_STEPS, **args)),
                ("captured", lambda: eng.rollout(u0, N_STEPS, captured=True,
                                                 **args))):
            counts, busy, ms, tries = profiled_counts(fn, want)
            fam[mode] = {"kernels": counts, "busy_share": busy, "ms": ms,
                         "attempts": tries}
            if counts != want:
                failures.append(f"{name} {mode}: profiled {counts}, want "
                                f"{want}")
        rec["families"][name] = fam
        replays[name] = fam["captured"]["kernels"]
        del eng
        torch.cuda.empty_cache()
    # the var1d path, which runs neither kernel: its busy share
    eng = SurrogateEngine.from_config(V1_CFG, pde=var1d_pde(), device="cuda")
    eng.init_params(seed=seed)
    vu0, vcond = var1d_serving_inputs(seed)
    eng.rollout(vu0, V1_STEPS, cond=vcond)
    eng.rollout(vu0, V1_STEPS, cond=vcond, captured=True)
    rec["var1d"] = {}
    for mode, fn in (
            ("eager", lambda: eng.rollout(vu0, V1_STEPS, cond=vcond)),
            ("captured", lambda: eng.rollout(vu0, V1_STEPS, cond=vcond,
                                             captured=True))):
        counts, busy, ms, tries = profiled_counts(fn, {})
        rec["var1d"][mode] = {"kernels": counts, "busy_share": busy,
                              "ms": ms, "attempts": tries}
        if counts:
            failures.append(f"var1d {mode}: profiled {counts}, want none")
    del eng
    torch.cuda.empty_cache()
    want = family_launches(*FAMILIES["ufno"][:2], N_STEPS, False)
    rec["export"] = {}
    art = load_exported(artifact)
    art.rollout(u0, **args)   # warm-up: cuDNN's timing
    for b in (BATCH, 2):
        counts, busy, ms, tries = profiled_counts(lambda: art.rollout(
            u0[:b], cond=cond[:b], spatial_cond=sc[:b]), want)
        rec["export"][str(b)] = {"kernels": counts, "busy_share": busy,
                                 "ms": ms, "attempts": tries}
        if counts != want:
            failures.append(f"artifact at batch {b}: profiled {counts}, "
                            f"want {want}")
    rec["gn_bwd_by_name"], bad = gn_bwd_by_name()
    GN_BWD_BY_NAME.update(rec["gn_bwd_by_name"])
    failures += bad
    emit({**rec, "card": card})
    if failures:
        raise AssertionError("; ".join(failures))
    return replays


def phase_train(seed, card, out_dir, tmp, gen_s):
    """Train the main path, the U-FNO (family_train), on the split made in
    ``gen_s`` seconds. Returns the training run's launches."""
    rec, launches, failures = family_train("ufno", seed, out_dir, tmp)
    emit({"phase": "train", "config": family_cfg("ufno"),
          "data": {"sims": TRAIN_SIMS, "nt": TRAIN_NT, "grid": [NX1, NX2],
                   "channels": 1, "cut": "--dataset.c_filter=[0]",
                   "generate_seconds": gen_s},
          **rec, "card": card, "tf32": False})
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


def weight_pack_record(steps, model):
    """The spectral conv's weight pack (``pack_weights_2d``: two permuting
    copies into the kernel's layout), which every K1 forward launch with
    gradients, and every one in a train step's no-grad pushforward, makes
    anew: device ms per call at the weight shape of ``model``'s first 2D
    spectral conv (graph replay), its calls in each timed train step of
    ``steps`` (its K1 forward launches) and their share of that step's
    time."""
    import torch

    from nps_tpu_torch.models.fno import SpectralConvND
    from nps_tpu_torch.ops.spectral import pack_weights_2d

    shape = next(tuple(m.weights1.shape) for m in model.modules()
                 if isinstance(m, SpectralConvND) and m.nd == 2)
    w = [torch.rand(shape, device="cuda") for _ in range(2)]
    rec = {"shape": list(shape)}
    timed(rec, lambda: pack_weights_2d(w), "ms")
    for depth, st in steps.items():
        calls = st["launches"].get("spectral_dft2d_fwd", 0)
        rec[f"depth{depth}"] = {
            "calls": calls, "step_ms": st["ms_per_step"],
            "share": (calls * rec["ms"] / st["ms_per_step"]
                      if rec["ms"] else None)}
    return rec


def phase_families(seed, card, out_dir, tmp):
    """The other four twophase families (Dilated ResNet, U-Net, FNO ->
    U-FNO, MP-GNN) at full width, each served (eager and captured) and
    trained on the card (one record each). Returns each path's launches, by
    "<family>_serve" and "<family>_train"."""
    import gc

    import torch

    paths, failures = {}, []
    for name in FAMILIES:
        if name == "ufno":
            continue
        serve, paths[f"{name}_serve"], bad_serve = family_serve(name, seed)
        train, paths[f"{name}_train"], bad_train = family_train(
            name, seed, out_dir, tmp)
        emit({"phase": "family", "family": name, "config": family_cfg(name),
              "serve": serve, "train": train, "card": card, "tf32": False})
        failures += [f"{name}: {f}" for f in bad_serve + bad_train]
        gc.collect()
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return paths


def phase_p13a(seed, card, gen, out_dir, tmp):
    """The model pieces no shipped config uses, at full width: the
    time-conditioned U-FNO trained (family_train, with test_step in its
    epoch's evaluation) and K1 and K2 timed and held at its train step's
    largest new shapes; the U-Net with attention served and trained
    (family_serve, family_train); the 3D FNO and Dilated ResNet card
    against CPU (d3_record). One line each. Returns each path's launches
    (by "<model>_serve" and "<model>_train") and the kernel records at the
    time-conditioned shapes (by kernel)."""
    import gc

    import torch

    paths, failures = {}, []
    train, paths["ufno_tcond_train"], bad = family_train(
        "ufno_tcond", seed, out_dir, tmp)
    failures += [f"ufno_tcond: {f}" for f in bad]
    rows = train["kernels_at_train_shapes"]
    gn_shape = max((tuple(r["shape"]) for r in rows if r["op"] == "GNGeluFn"),
                   key=math.prod)
    sp_shape = next(tuple(r["shape"]) for r in rows
                    if r["op"] == "SpectralConv2dFn")
    kern = {"gn1_gelu_fwd": gn_fwd_record(gen, gn_shape),
            "gn1_gelu_bwd": gn_bwd_record(gen, gn_shape),
            "spectral_dft2d_fwd": spectral_fwd_record(gen, sp_shape)}
    kern["spectral_dft2d_bwd"], kern["spectral_dw2d"] = (
        spectral_bwd_records(gen, sp_shape))
    cfg, over, (gn_calls, spec_calls, *_) = family_spec("ufno_tcond")
    emit({"phase": "p13a", "model": "ufno_tcond", "config": cfg,
          "overrides": over, "t_conditioning": [TRAIN_SIMS, TCOND_CHANNELS,
                                                TRAIN_NT],
          "per_apply": {"gn1_gelu_fwd": gn_calls,
                        "spectral_dft2d_fwd": spec_calls},
          "spectral_input": list(sp_shape), "largest_gn_input":
          list(gn_shape), "train": train, "card": card, "tf32": False})
    gc.collect()
    torch.cuda.empty_cache()

    serve, paths["unet_attn_serve"], bad_serve = family_serve("unet_attn",
                                                              seed)
    train, paths["unet_attn_train"], bad_train = family_train(
        "unet_attn", seed, out_dir, tmp)
    cfg, over, _ = family_spec("unet_attn")
    emit({"phase": "p13a", "model": "unet_attn", "config": cfg,
          "overrides": over, "serve": serve, "train": train, "card": card,
          "tf32": False})
    failures += [f"unet_attn: {f}" for f in bad_serve + bad_train]
    gc.collect()
    torch.cuda.empty_cache()

    for name in ("fno", "drn"):
        rec, bad = d3_record(name, seed)
        emit({"phase": "p13a", "model": f"{name}_3d", **rec, "card": card,
              "tf32": False})
        failures += [f"{name}_3d: {f}" for f in bad]
    if failures:
        raise AssertionError("; ".join(failures))
    return paths, kern


def d3_record(name, seed):
    """The 3D ``name`` model ("fno" or "drn": an EncProcDec of D3_HIDDEN
    features, 2 blocks, D3_MODES modes a dimension, on D3_GRID; no shipped
    config) on the card and on the CPU from the same seeded weights and
    inputs: the forward (REL_TOL_STEP) and one grad step, its loss
    sqrt(sum (pred - labels)^2) (REL_TOL_STEP) and every gradient
    (REL_TOL_3D_GRAD; a tensor below 1e-5 of the largest held at that
    floor), with the card's forward
    and step times (median of 3 after a warm-up, host clock around
    synchronised calls). Returns (record, failures)."""
    import numpy as np
    import torch

    from nps_tpu_torch.models.enc_proc_dec import EncProcDec
    from nps_tpu_torch.models.initializers import reset_parameters
    from nps_tpu_torch.pde import PDE3D

    n1, n2, n3 = D3_GRID
    pde = PDE3D(tmin=0.0, tmax=1.0, nt=11, L1=1.0, L2=1.0, L3=0.5, nx1=n1,
                nx2=n2, nx3=n3, x=None, name="box3d", n_cond_static=N_STATIC)
    cfg = dict(num_c=1, num_spatial_dims=3, time_window=D3_TW,
               encoder="enc_grid.ElementWise",
               decoder="dec_grid.TimeConvDense",
               dec_delta_mode="per_step", activation="gelu",
               hidden_features=D3_HIDDEN, hidden_blocks=2)
    cfg.update(dict(processor="FNO", fno_modes=D3_MODES) if name == "fno"
               else dict(processor="DilatedResnet", kernel_size=3,
                         padding_mode="circular"))
    rng = np.random.default_rng(seed + 3)
    u = (0.5 + rng.random((D3_BATCH, 1, D3_TW, *D3_GRID))).astype(np.float32)
    cond = rng.random((D3_BATCH, N_STATIC)).astype(np.float32)
    pos = np.broadcast_to(pde.x.astype(np.float32)[None],
                          (D3_BATCH, *D3_GRID, 3)).copy()
    labels = np.roll(u, -1, axis=2)

    def run(device):
        model = EncProcDec(pde=pde, **cfg)
        reset_parameters(model, torch.Generator().manual_seed(seed))
        model.to(device)
        t = {k: torch.from_numpy(v).to(device) for k, v in
             dict(u=u, cond=cond, pos=pos, labels=labels).items()}

        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()

        def forward():
            with torch.no_grad():
                return model(t["u"], cond=t["cond"], pos=t["pos"])

        def step():
            model.zero_grad(set_to_none=True)
            pred = model(t["u"], cond=t["cond"], pos=t["pos"])
            loss = torch.sqrt(torch.sum((pred - t["labels"]) ** 2))
            loss.backward()
            return loss.detach()

        out = forward().cpu().numpy()
        loss = float(step())
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        times = {}
        if device == "cuda":
            for key, fn in (("forward_ms", forward), ("step_ms", step)):
                ms = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    ms.append(1e3 * (time.perf_counter() - t0))
                times[key] = sorted(ms)[1]
            times["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        n_params = sum(p.numel() for p in model.parameters())
        return out, loss, grads, times, n_params

    out_gpu, loss_gpu, grads_gpu, times, n_params = run("cuda")
    out_cpu, loss_cpu, grads_cpu, _, _ = run("cpu")
    fwd_err = float(np.abs(out_gpu - out_cpu).max() / np.abs(out_cpu).max())
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    grad_err, grad_worst = _grad_errors(grads_gpu, grads_cpu)
    rec = {"grid": list(D3_GRID), "batch": D3_BATCH, "time_window": D3_TW,
           "hidden": D3_HIDDEN, "blocks": 2, "parameters": n_params,
           **({"modes": [D3_MODES] * 3} if name == "fno" else
              {"kernel_size": 3}),
           "out_shape": list(out_gpu.shape),
           "finite": bool(np.isfinite(out_gpu).all()),
           "forward_rel_err_vs_cpu": fwd_err, "loss_gpu": loss_gpu,
           "loss_cpu": loss_cpu, "loss_rel_err_vs_cpu": loss_err,
           "grad_rel_err_vs_cpu": grad_err, "worst_grad": grad_worst,
           **times}
    failures = []
    if tuple(out_gpu.shape) != u.shape or not rec["finite"]:
        failures.append(f"output {out_gpu.shape}, finite {rec['finite']}")
    if not (fwd_err < REL_TOL_STEP and loss_err < REL_TOL_STEP
            and grad_err < REL_TOL_3D_GRAD):
        failures.append(f"card vs CPU: forward {fwd_err}, loss {loss_err}, "
                        f"gradients {grad_err} ({grad_worst})")
    return rec, failures


def first_batch(trainer):
    """The first train batch of ``trainer``'s split, on its device."""
    from nps_tpu_torch.data.pipeline import prefetch_to_device

    batches = prefetch_to_device(iter(trainer.get_dataloaders()[0]),
                                 trainer.device)
    batch = next(batches)
    batches.close()
    return batch


def gn_tanh_records(gen):
    """K2's f32 forward with the tanh GELU (act 2, the pushforward_fast
    applies' form of the U-FNO's GroupNorms) at GN_SHAPES against its plain
    version, beside its bound, the plain version's time and the library
    call's (F.group_norm + F.gelu(approximate="tanh"), graph replay)."""
    import torch
    import torch.nn.functional as F

    from nps_tpu_torch.ops import group_norm as gn

    recs = []
    for shape in GN_SHAPES:
        c = shape[1]
        x = torch.randn(shape, device="cuda", generator=gen) * 1.5 + 0.3
        gamma = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=gen)
        beta = 0.1 * torch.randn(c, device="cuda", generator=gen)
        y = gn.gn1_gelu_fwd(x, gamma, beta, approximate="tanh")
        ref = gn.gn_gelu_plain(x, gamma, beta, approximate="tanh")
        rec = {"shape": shape, "rel_err": rel_err(y, ref),
               "max_abs_err": float((y - ref).abs().max())}
        rec["bound_ms"], rec["bound_by"] = gn_bound([shape])
        timed(rec, lambda: gn.gn1_gelu_fwd(x, gamma, beta,
                                           approximate="tanh"), "ms")
        timed(rec, lambda: gn.gn_gelu_plain(x, gamma, beta,
                                            approximate="tanh"), "plain_ms")
        timed(rec, lambda: F.gelu(F.group_norm(x, 1, gamma, beta),
                                  approximate="tanh"), "library_ms")
        rec["bound_share"] = rec["bound_ms"] / rec["ms"] if rec["ms"] else None
        recs.append(rec)
    return recs


def phase_pushforward_fast(seed, card, gen, tmp):
    """The U-FNO (cfg_twophase_ufno, full width) trained with
    --trainer.pushforward_fast=true on the split in ``tmp``: a depth-0 step
    against the flag-off trainer's (same weights, batch and start steps;
    cuDNN's deterministic algorithms): the loss bit for bit; then depth-8
    steps timed (their launches as the flag-off step's), where the 8
    no-grad applies launch K2 with act 2 (tanh) and the graded apply with
    act 1 (erf), read from ``kernels.act_launches``; and K2's f32 tanh
    forward at GN_SHAPES against its plain version (gn_tanh_records)."""
    import gc

    import torch

    from nps_tpu_torch import kernels
    from nps_tpu_torch.inference import autotuned_convs

    gn_calls, spec_calls = FAMILIES["ufno"][:2]
    argv = train_argv(tmp, seed, 1, "train_ufno_fast")
    off = build_trainer(family_cfg("ufno"), argv, "cuda")
    on = build_trainer(family_cfg("ufno"),
                       argv + ["--trainer.pushforward_fast=true"], "cuda")
    for t in (off, on):
        t.ensure_initialized()
    on.model.load_state_dict(off.model.state_dict())
    batch = first_batch(off)
    steps0 = torch.randint(TW, TRAIN_NT - TW + 1, (TRAIN_BATCH,),
                           generator=torch.Generator().manual_seed(seed))
    failures = []
    with autotuned_convs(deterministic=True):
        loss_off = off.train_step(batch, 0, 0, unrolled=0, steps0=steps0)[0]
        loss_on = on.train_step(batch, 0, 0, unrolled=0, steps0=steps0)[0]
        params_equal = all(torch.equal(a, b) for a, b in zip(
            off.model.parameters(), on.model.parameters()))
    del off
    gc.collect()
    depth = TRAIN_DEPTHS[-1]
    want = family_launches(gn_calls, spec_calls, depth + 1, True)
    with autotuned_convs():
        on.train_step(batch, 0, 0, unrolled=depth)  # warm-up
        kernels.reset_launches()
        on.train_step(batch, 0, 0, unrolled=depth)
        torch.cuda.synchronize()
        acts = {f"{name}/act{act}": n
                for (name, act), n in sorted(kernels.act_launches.items())}
        steps = timed_steps(on, batch, depth, want, 3)
    want_acts = {"gn1_gelu_fwd/act1": gn_calls,
                 "gn1_gelu_fwd/act2": gn_calls * depth}
    tanh = gn_tanh_records(gen)
    rec = {"phase": "pushforward_fast", "config": family_cfg("ufno"),
           "flag": "--trainer.pushforward_fast=true",
           "depth0": {"loss_off": float(loss_off), "loss_on": float(loss_on),
                      "bitwise_equal": float(loss_off) == float(loss_on),
                      "params_equal_after_adam": params_equal},
           "depth": depth, "act_launches": acts,
           "act_launches_expected": want_acts, "step": steps,
           "gn1_gelu_fwd_tanh_f32": tanh, "card": card, "tf32": False}
    emit(rec)
    if float(loss_off) != float(loss_on):
        failures.append(f"depth-0 loss with the flag {float(loss_on)} != "
                        f"without {float(loss_off)}")
    if not params_equal:
        failures.append("depth-0 parameters after Adam differ with the flag")
    if acts != want_acts:
        failures.append(f"K2 launches by activation {acts}, want "
                        f"{want_acts}")
    if not steps["launches_ok"]:
        failures.append(f"depth-{depth} launches {steps['launches']}, want "
                        f"{want}")
    bad = [r for r in tanh if not r["rel_err"] < REL_TOL_F32]
    if bad:
        failures.append(f"K2 f32 tanh disagrees: {bad}")
    del on
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))


def gnn_bf16(seed, card, tmp):
    """cfg_twophase_gnn at full width in bf16: one serving step (batch 2)
    and one depth-1 train step (batch 2, same weights and start steps) on
    the card against the port on the CPU in bf16, held at the bf16 bar with
    the CPU in f32 as the reference (|card - CPU_bf16| / |CPU_f32| <=
    max(2 d, BF16_FLOOR), d the CPU's own bf16-vs-f32 deviation; the output
    and loss in max terms, the gradients over all parameters in RMS terms);
    then the bf16 train step timed at depth 0 and batch 16 (no hand kernel
    may launch)."""
    import gc

    import numpy as np
    import torch

    from nps_tpu_torch.inference import SurrogateEngine, autotuned_convs

    cfg = family_cfg("gnn")
    pde = twophase_pde()
    engines = {}
    for dev, dtype in (("cuda", "bfloat16"), ("cpu", "bfloat16"),
                       ("cpu", None)):
        engines[dev, dtype] = SurrogateEngine.from_config(
            cfg, pde=pde, device=dev, compute_dtype=dtype)
    engines["cuda", "bfloat16"].init_params(seed=seed)
    state = engines["cuda", "bfloat16"].model.state_dict()
    u0, cond, _ = serving_inputs(seed)
    out = {}
    for key, eng in engines.items():
        if key[0] == "cpu":
            eng.model.load_state_dict({k: v.cpu() for k, v in state.items()})
        out[key] = eng.step(u0[:2], cond=cond[:2])
    del engines
    gc.collect()

    def bar(got, ref16, ref32, norm):
        scale = norm(ref32)
        d, err = norm(ref16 - ref32) / scale, norm(got - ref16) / scale
        return {"rel_err": float(err), "cpu_bf16_vs_f32": float(d),
                "bar": float(max(2 * d, BF16_FLOOR))}

    def amax(a):
        return float(np.abs(a).max())

    serve = bar(out["cuda", "bfloat16"], out["cpu", "bfloat16"],
                out["cpu", None], amax)
    serve["finite"] = bool(np.isfinite(out["cuda", "bfloat16"]).all())

    argv = train_argv(tmp, seed, 1, "train_gnn_bf16")
    bf16 = ["--trainer.compute_dtype=bfloat16"]
    card16 = build_trainer(cfg, argv + bf16, "cuda")
    card16.ensure_initialized()
    batch = first_batch(card16)
    small = tuple(t[:2] for t in batch)
    steps0 = torch.randint(TW, TRAIN_NT - 2 * TW + 1, (2,),
                           generator=torch.Generator().manual_seed(seed))
    # copies, taken before the card's step moves its weights
    state = {k: v.detach().cpu().clone()
             for k, v in card16.model.state_dict().items()}
    losses, grads = {}, {}
    for key, extra in (("card", bf16), ("cpu_bf16", bf16), ("cpu_f32", [])):
        t = (card16 if key == "card"
             else build_trainer(cfg, argv + extra, "cpu"))
        t.ensure_initialized()
        t.model.load_state_dict(state)
        b = small if key == "card" else tuple(x.cpu() for x in small)
        losses[key] = float(t.train_step(b, 0, 0, unrolled=1,
                                         steps0=steps0)[0])
        grads[key] = np.concatenate([p.grad.detach().float().cpu().numpy()
                                     .ravel() for _, p in sorted(
                                         t.model.named_parameters())])
        if key != "card":
            del t
    train = {"loss": bar(np.float64(losses["card"]),
                         np.float64(losses["cpu_bf16"]),
                         np.float64(losses["cpu_f32"]), amax),
             "grads": bar(grads["card"], grads["cpu_bf16"], grads["cpu_f32"],
                          lambda a: float(np.sqrt(np.mean(np.square(a))))),
             "losses": losses}
    with autotuned_convs():
        timed_d0 = timed_steps(card16, batch, 0, {}, 3)
    rec = {"phase": "gnn_bf16", "config": cfg, "compute_dtype": "bfloat16",
           "serve_step": serve, "train_step": train, "step_d0": timed_d0,
           "card": card, "tf32": False}
    emit(rec)
    del card16
    gc.collect()
    torch.cuda.empty_cache()
    failures = [f"gnn bf16 {what}: {r}" for what, r in (
        ("serving step", serve), ("train loss", train["loss"]),
        ("train gradients", train["grads"])) if not r["rel_err"] <= r["bar"]]
    if not serve["finite"]:
        failures.append("gnn bf16 serving step is not finite")
    if not timed_d0["launches_ok"]:
        failures.append(f"gnn bf16 launched {timed_d0['launches']}")
    if failures:
        raise AssertionError("; ".join(failures))


def ns512_split(tmp, seed):
    """The ns512 split (NS_SIMS simulations of NS_NT frames at 512x512, one
    channel, from the port's generator) read through PDE2DDataset: the
    dataset, the serving batch (each simulation's first window, then the
    window after it), and the seconds the split took to write."""
    import numpy as np

    from nps_tpu_torch.data.pde2d import PDE2DDataset
    from nps_tpu_torch.data.synthetic import generate

    t0 = time.perf_counter()
    generate(f"{tmp}/ns512/ns512", n_sims=NS_SIMS, n_channels=1, nt=NS_NT,
             nx1=NS_N, nx2=NS_N, seed=seed)
    gen_s = time.perf_counter() - t0
    ds = PDE2DDataset(f"{tmp}/ns512", "ns512", "memmap", "snapshots",
                      conditioning="conditioning",
                      spatial_conditioning="spatial_conditioning",
                      c_filter=[0], split_file="split", name="ns512")
    u0, cond, sc = [], [], []
    for i in range(NS_BATCH):
        _, u, _, c, _, s = ds.dataset[i % NS_SIMS]
        t = NS_TW * (i // NS_SIMS)
        u0.append(np.asarray(u[:, t:t + NS_TW]))
        cond.append(np.asarray(c))
        sc.append(np.asarray(s))
    return ds, (np.stack(u0), np.stack(cond), np.stack(sc)), gen_s


@contextlib.contextmanager
def tanh_gelus():
    """Count the tanh F.gelu calls inside the block by caller
    ("file:function", the first frame outside the activation objects)."""
    import torch.nn.functional as F

    calls, wrapped = collections.Counter(), F.gelu

    def counting(x, approximate="none"):
        if approximate == "tanh":
            f = sys._getframe(1)
            while f.f_code.co_filename.endswith("activations.py"):
                f = f.f_back
            calls[f"{Path(f.f_code.co_filename).name}:"
                  f"{f.f_code.co_name}"] += 1
        return wrapped(x, approximate=approximate)

    F.gelu = counting
    try:
        yield calls
    finally:
        F.gelu = wrapped


@contextlib.contextmanager
def gn_inputs_seen():
    """The (shape, dtype, activation) of every gn1_gelu_fwd_stats call inside
    the block (the persistent and the streaming variant's wrapper), in
    order."""
    from nps_tpu_torch.ops import group_norm as gn

    seen, wrapped = [], gn.gn1_gelu_fwd_stats

    def record(x, weight, bias, gelu=True, eps=gn.EPS, approximate="none"):
        seen.append((tuple(x.shape), str(x.dtype), gn_act(gelu, approximate)))
        return wrapped(x, weight, bias, gelu, eps, approximate)

    gn.gn1_gelu_fwd_stats = record
    try:
        yield seen
    finally:
        gn.gn1_gelu_fwd_stats = wrapped


def ns512_serve(seed, ds, batch):
    """The full-width cfg_ns512_ufno (bf16, from its config) built by
    SurrogateEngine.from_config over the split's PDE, random weights from
    the seed: ROLLOUTS eager rollouts of NS_STEPS bundled steps at batch 8
    (the rate is their median; launch counts set to 0 just before each and
    read just after), the same rollouts captured (the first call captures;
    the rate is the median of ROLLOUTS replays; against eager, CAPTURED_TOL),
    peak memory, the GN+GELU inputs of one step, and one step of the same
    weights served in f32 on the card (its nRMSE against bf16 under
    NS_F32_TOL; the largest relative deviation beside it). Returns (record,
    the first rollout's launches, failures)."""
    import numpy as np
    import torch

    from nps_tpu_torch import kernels
    from nps_tpu_torch.inference import SurrogateEngine

    u0, cond, sc = batch
    eng = SurrogateEngine.from_config(NS_CFG, pde=ds.pde, device="cuda")
    eng.init_params(seed=seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with gn_inputs_seen() as seen, tanh_gelus() as gelus:
        step = eng.step(u0, cond=cond, spatial_cond=sc)   # also warms up
    warm_s = time.perf_counter() - t0
    seconds, launches = [], []
    for _ in range(ROLLOUTS):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.rollout(u0, NS_STEPS, cond=cond, spatial_cond=sc)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches.append(dict(kernels.launches))
    median = sorted(seconds)[len(seconds) // 2]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    def captured():
        return eng.rollout(u0, NS_STEPS, cond=cond, spatial_cond=sc,
                           captured=True)

    kernels.reset_launches()
    t0 = time.perf_counter()
    out_c = captured()
    capture_s = time.perf_counter() - t0
    capture_launches = dict(kernels.launches)
    c_seconds = []
    for _ in range(ROLLOUTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_c = captured()
        torch.cuda.synchronize()
        c_seconds.append(time.perf_counter() - t0)
    c_median = sorted(c_seconds)[len(c_seconds) // 2]
    captured_err = float(np.abs(out_c - out).max() / np.abs(out).max())
    eng.clear_captured()
    peak_captured = torch.cuda.max_memory_allocated() / 2 ** 30

    # the first NS_F32_BATCH samples in f32 (cuDNN times its f32 algorithms
    # at 512x512 for ~16 s at batch 8)
    f32 = SurrogateEngine.from_config(NS_CFG, pde=ds.pde, device="cuda",
                                      compute_dtype="float32")
    f32.model.load_state_dict(eng.model.state_dict())
    nb = NS_F32_BATCH
    t0 = time.perf_counter()
    step_f32 = f32.step(u0[:nb], cond=cond[:nb], spatial_cond=sc[:nb])
    f32_s = time.perf_counter() - t0
    diff = step[:nb] - step_f32
    f32_max = float(np.abs(diff).max() / np.abs(step_f32).max())
    f32_nrmse = float(np.sqrt(np.mean(diff ** 2) / np.mean(step_f32 ** 2)))
    del f32
    shapes = {}
    for shape, dtype, act in seen:
        key = (shape, dtype, act)
        shapes[key] = shapes.get(key, 0) + 1
    want = {"spectral_dft2d_fwd_large": NS_BLOCKS * NS_STEPS,
            "gn1_gelu_fwd": sum(n for (s, _, _), n in shapes.items()
                                if not _streams(s)) * NS_STEPS,
            "gn1_gelu_fwd_stream": sum(n for (s, _, _), n in shapes.items()
                                       if _streams(s)) * NS_STEPS}
    want = {k: v for k, v in want.items() if v}
    rec = {"config": NS_CFG, "batch": NS_BATCH, "bundled_steps": NS_STEPS,
           "compute_dtype": str(eng.compute_dtype),
           "parameters": sum(p.numel() for p in eng.model.parameters()),
           "out_shape": list(out.shape),
           "finite": bool(np.isfinite(out).all()),
           "launches": launches[0], "launches_expected": want,
           "first_step_seconds": warm_s,
           "rollout_seconds": seconds,
           "bundled_steps_per_s": NS_STEPS / median,
           "samples_steps_per_s": NS_BATCH * NS_STEPS / median,
           "peak_mem_gib": peak,
           "captured": {"bundled_steps_per_s": NS_STEPS / c_median,
                        "rollout_seconds": c_seconds,
                        "capture_seconds": capture_s,
                        "rel_err_vs_eager": captured_err,
                        "launches_at_capture": capture_launches,
                        "peak_mem_gib": peak_captured},
           "f32_step": {"batch": nb, "nrmse_bf16_vs_f32": f32_nrmse,
                        "max_rel_dev_bf16_vs_f32": f32_max,
                        "seconds": f32_s},
           "gn_inputs": [[list(s), d, g, n]
                         for (s, d, g), n in sorted(shapes.items())],
           "tanh_gelu_calls": dict(gelus),
           "tanh_gelu_calls_expected": NS_TANH_PER_APPLY}
    failures = []
    if dict(gelus) != NS_TANH_PER_APPLY or any(a != "tanh" for _, _, a in
                                               seen):
        failures.append(f"ns512 serving step: tanh F.gelu calls "
                        f"{dict(gelus)} (want {NS_TANH_PER_APPLY}), K2 "
                        f"activations {sorted({a for _, _, a in seen})}")
    if tuple(out.shape) != (NS_BATCH, 1, NS_STEPS * NS_TW, NS_N, NS_N):
        failures.append(f"ns512 rollout shape {out.shape}")
    if not rec["finite"]:
        failures.append("ns512 rollout has non-finite values")
    if any(n != want for n in launches):
        failures.append(f"ns512 serving launches {launches} != {want}")
    if not captured_err <= CAPTURED_TOL:
        failures.append(f"ns512 captured rollout vs eager: {captured_err}")
    if not f32_nrmse < NS_F32_TOL:
        failures.append(f"ns512 bf16 vs f32 step: nRMSE {f32_nrmse}")
    del eng
    return rec, launches[0], failures


def _streams(shape, itemsize=2):
    """Whether gn1_gelu_fwd takes ``shape`` (bf16 unless ``itemsize``)
    with its streaming variant."""
    from nps_tpu_torch.ops import group_norm as gn

    return gn._plan(shape[0], math.prod(shape[1:]), itemsize == 2) is None


def ns512_narrow(seed, ds, batch):
    """A narrow model (NS_NARROW: 1 block x 16 features, 20 modes, f32) at
    512x512, batch 2: one step on the card (its K1 planes take the
    large-plane variant, its top GroupNorm inputs the streaming one) against
    the port on the CPU (REL_TOL_STEP). Returns (record, failures)."""
    import numpy as np

    from nps_tpu_torch import kernels
    from nps_tpu_torch.inference import SurrogateEngine

    u0, cond, sc = (a[:2] for a in batch)
    kw = dict(pde=ds.pde, overrides=NS_NARROW, compute_dtype="float32")
    card = SurrogateEngine.from_config(NS_CFG, device="cuda", **kw)
    card.init_params(seed=seed)
    cpu = SurrogateEngine.from_config(NS_CFG, device="cpu", **kw)
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               card.model.state_dict().items()})
    card.step(u0, cond=cond, spatial_cond=sc)   # cuDNN's timing
    kernels.reset_launches()
    with gn_inputs_seen() as seen:
        got = card.step(u0, cond=cond, spatial_cond=sc)
    launches = dict(kernels.launches)
    t0 = time.perf_counter()
    ref = cpu.step(u0, cond=cond, spatial_cond=sc)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    rec = {"overrides": NS_NARROW, "batch": 2, "compute_dtype": "float32",
           "step_rel_err_vs_cpu": err, "cpu_step_seconds": cpu_s,
           "launches": launches,
           "largest_gn_input": max((s for s, _, _ in seen), key=math.prod,
                                   default=None)}
    failures = []
    if not err < REL_TOL_STEP:
        failures.append(f"ns512 narrow step card vs CPU: {err}")
    for name in ("spectral_dft2d_fwd_large", "gn1_gelu_fwd_stream"):
        if not launches.get(name):
            failures.append(f"ns512 narrow step launched no {name}: "
                            f"{launches}")
    return rec, failures


# the DFT stage kernels of a large-plane call, by the stages it takes
# (ops/spectral.py: large_stages)
LARGE_STAGE_KERNELS = {"tensor": ("dft_fwd_tc_kernel", "dft_inv_tc_kernel"),
                       "fma": ("dft_fwd_big_kernel", "dft_inv_big_kernel")}


def phase_stages(gen):
    """Last, after the profile phase (a profiler session slows the host for
    the rest of the process): each kernel of the large-plane spectral conv
    at the ns512 call, forward ([8, 132, 512, 512] -> 128) and input
    gradient (dy [8, 128, 512, 512] -> 132), in bf16 and f32, timed by
    torch.profiler (``trace_step.kernel_ms``); fails unless the DFT stages
    that the call's type and alignment choose ran (``large_stages``: the
    tensor-core ones in bf16). Returns {record name: {dtype: stages}}."""
    import torch

    from nps_tpu_torch.ops import spectral as sp
    from nps_tpu_torch.trace_step import kernel_ms

    b, ci, n1, n2 = NS_SPEC_SHAPE
    co, m = NS_HIDDEN, (NS_MODES, NS_MODES)
    ws = [torch.rand((2, ci, co, *m), device="cuda", generator=gen)
          / (ci * co) for _ in range(2)]
    packed = sp.pack_weights_2d(ws)
    out = {}
    for name, shape, fn in (
            ("spectral_dft2d_fwd_large", NS_SPEC_SHAPE,
             lambda t: sp.spectral_dft2d_fwd(t, packed, m)),
            ("spectral_dft2d_bwd_large", (b, co, n1, n2),
             lambda t: sp.spectral_dft2d_bwd(t, packed, m)[0])):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            y = fn(x)
            chosen = sp.large_stages(dtype, n2, x.data_ptr(), y.data_ptr())
            per, span = kernel_ms(lambda: fn(x))
            rec = {"chosen": chosen, "call_span_ms": span,
                   "kernel_ms": per}
            emit({"phase": "stages", "name": name, "dtype": str(dtype),
                  **rec})
            want = LARGE_STAGE_KERNELS[chosen]
            if not all(k in per for k in want):
                raise AssertionError(f"{name} ({dtype}): the {chosen} "
                                     f"stages {want} did not run: "
                                     f"{sorted(per)}")
            out.setdefault(name, {})[str(dtype)] = rec
            del x, y
    return out


def spectral_large_record(gen, dtype):
    """spectral_dft2d_fwd at the ns512 call (NS_SPEC_SHAPE -> NS_HIDDEN,
    NS_MODES x NS_MODES) in ``dtype``: its large-plane variant against the
    plain version, twice for the same bits, timed (graph replay) beside the
    plain version, rfft2 + einsum + irfft2 (on x in f32) and the bound (the
    operations at the input type's peak; the f32 CUDA-core bound apart)."""
    import torch

    from nps_tpu_torch import kernels
    from nps_tpu_torch.ops import spectral as sp

    b, ci, n1, n2 = NS_SPEC_SHAPE
    co, m = NS_HIDDEN, (NS_MODES, NS_MODES)
    x = torch.randn(NS_SPEC_SHAPE, device="cuda", generator=gen).to(dtype)
    ws = [torch.rand((2, ci, co, *m), device="cuda", generator=gen)
          / (ci * co) for _ in range(2)]
    packed = sp.pack_weights_2d(ws)
    kernels.reset_launches()
    y_k = sp.spectral_dft2d_fwd(x, packed, m)
    launched = dict(kernels.launches)
    y_again = sp.spectral_dft2d_fwd(x, packed, m)
    y_p = sp.spectral_conv_2d_plain(x, ws, m)
    torch.cuda.synchronize()
    err = rel_err(y_k, y_p)
    w_c = complex_weights(*ws)
    err_library = rel_err(rfft_conv(x.float(), w_c, m), y_p)
    flops = spectral_flops(b, ci, co, n1, n2, *m)
    nbytes = (x.element_size() * (x.numel() + b * co * n1 * n2)
              + 4 * packed.numel())
    bf16 = dtype == torch.bfloat16
    bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16 if bf16 else PEAK_F32)
    rec = {"phase": "kernel", "name": "spectral_dft2d_fwd_large",
           "dtype": str(dtype), "shape": [list(NS_SPEC_SHAPE), co, list(m)],
           "launched": launched, "rel_err": err,
           "same_bits": bool(torch.equal(y_k, y_again)),
           "rel_err_library_vs_plain": err_library,
           "max_abs_err": float((y_k.float() - y_p.float()).abs().max()),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_f32_ops_ms": flops / PEAK_F32 * 1e3,
           "bound_how": f"x + out in {dtype}, f32 weights once at 3.35 TB/s "
                        f"({nbytes} B); {flops} flop at "
                        f"{'989 TFLOP/s bf16' if bf16 else '67 TFLOP/s f32'}"}
    for key, fn in (("ms", lambda: sp.spectral_dft2d_fwd(x, packed, m)),
                    ("plain_ms", lambda: sp.spectral_conv_2d_plain(x, ws, m)),
                    ("library_ms", lambda: rfft_conv(x.float(), w_c, m))):
        timed(rec, fn, key, **FEW_CALLS)
    rec["bound_share"] = bound_ms / rec["ms"] if rec["ms"] else None
    rec["f32_ops_share"] = (rec["bound_f32_ops_ms"] / rec["ms"] if rec["ms"]
                            else None)
    emit(rec)
    tol = REL_TOL_BF16 if bf16 else REL_TOL_F32
    if not (err < tol and rec["same_bits"]
            and launched == {"spectral_dft2d_fwd_large": 1}):
        raise AssertionError(f"spectral_dft2d_fwd_large ({dtype}): {err}, "
                             f"same bits {rec['same_bits']}, {launched}")
    return rec


def gn_stream_record(gen, shape, dtype, act):
    """gn1_gelu_fwd at an ns512 GroupNorm input in ``dtype`` (the variant
    its size selects) with the activation ``act`` (GN_ACT_KW) against the
    plain version, twice for the same bits, timed beside the plain version,
    F.group_norm (+ F.gelu) and two bounds: x read once and y written once
    (the bound), and the streaming design's two reads of x and one
    write."""
    import torch
    import torch.nn.functional as F

    from nps_tpu_torch import kernels
    from nps_tpu_torch.ops import group_norm as gn

    c, n = shape[1], math.prod(shape)
    x = (torch.randn(shape, device="cuda", generator=gen) * 1.5
         + 0.3).to(dtype)
    gamma = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=gen)
    beta = 0.1 * torch.randn(c, device="cuda", generator=gen)
    kw = GN_ACT_KW[act]
    kernels.reset_launches()
    y = gn.gn1_gelu_fwd(x, gamma, beta, **kw)
    launched = dict(kernels.launches)
    again = gn.gn1_gelu_fwd(x, gamma, beta, **kw)
    y_p = gn.gn_gelu_plain(x, gamma, beta, **kw)
    torch.cuda.synchronize()
    err = rel_err(y, y_p)
    size = x.element_size()
    bound_ms, bound_by = gn_bound([shape], size)
    rec = {"phase": "kernel", "name": "gn1_gelu (ns512 shape)",
           "shape": list(shape), "dtype": str(dtype), "act": act,
           "launched": launched, "rel_err": err,
           "same_bits": bool(torch.equal(y, again)),
           "max_abs_err": float((y.float() - y_p.float()).abs().max()),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "two_pass_floor_ms": 3 * size * n / PEAK_BYTES * 1e3}

    def library():
        z = F.group_norm(x, 1, gamma.to(dtype), beta.to(dtype))
        if act == "off":
            return z
        return F.gelu(z, approximate="tanh" if act == "tanh" else "none")

    for key, fn in (("ms", lambda: gn.gn1_gelu_fwd(x, gamma, beta, **kw)),
                    ("plain_ms", lambda: gn.gn_gelu_plain(x, gamma, beta,
                                                          **kw)),
                    ("library_ms", library)):
        timed(rec, fn, key, **FEW_CALLS)
    rec["bound_share"] = bound_ms / rec["ms"] if rec["ms"] else None
    emit(rec)
    tol = REL_TOL_BF16 if dtype == torch.bfloat16 else REL_TOL_F32
    if not (err < tol and rec["same_bits"]):
        raise AssertionError(f"gn1_gelu_fwd at {shape} {dtype}: {err}, "
                             f"same bits {rec['same_bits']}")
    return rec


def phase_ns512(seed, card, gen, tmp):
    """The ns512 slice: the split, the full-width bf16 serving (ns512_serve),
    the narrow model card against CPU (ns512_narrow), then the kernels at
    the ns512 shapes: the large-plane spectral conv in f32 and bf16, and
    GN+GELU at the largest and smallest GroupNorm inputs one step gave (f32
    and bf16). Returns (the first eager rollout's launches, the kernel
    records by name, the serving step's GroupNorm inputs)."""
    import gc

    import torch

    t0 = time.perf_counter()
    ds, batch, gen_s = ns512_split(tmp, seed)
    serve, launches, failures = ns512_serve(seed, ds, batch)
    gc.collect()
    torch.cuda.empty_cache()
    narrow, bad = ns512_narrow(seed, ds, batch)
    failures += bad
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "ns512", "data": {"sims": NS_SIMS, "nt": NS_NT,
                                     "grid": [NS_N, NS_N], "channels": 1,
                                     "generate_seconds": gen_s},
          "serve": serve, "narrow": narrow, "card": card, "tf32": False})
    if failures:
        raise AssertionError("; ".join(failures))
    recs = {"spectral_dft2d_fwd_large": spectral_large_record(
        gen, torch.bfloat16)}
    recs["spectral_dft2d_fwd_large"]["f32"] = spectral_large_record(
        gen, torch.float32)
    gn_shapes = [tuple(s) for s, _, _, _ in serve["gn_inputs"]]
    act = serve["gn_inputs"][0][2]
    records = [gn_stream_record(gen, shape, dtype, act)
               for shape in (max(gn_shapes, key=math.prod),
                             min(gn_shapes, key=math.prod))
               for dtype in (torch.bfloat16, torch.float32)]
    recs["gn1_gelu_fwd_stream"] = dict(records[0], shapes=[
        {k: r[k] for k in ("shape", "dtype", "act", "launched", "rel_err",
                           "same_bits", "ms", "plain_ms", "library_ms",
                           "bound_ms", "bound_share")}
        for r in records])
    gc.collect()
    torch.cuda.empty_cache()
    recs["seconds"] = time.perf_counter() - t0
    return launches, recs, serve["gn_inputs"]


@contextlib.contextmanager
def plain_calls():
    """Count the calls of the kernels' plain versions inside the block: the
    card's training path makes none."""
    from nps_tpu_torch.ops import group_norm as gn
    from nps_tpu_torch.ops import spectral as sp

    fns = [(gn, "gn_gelu_plain"), (sp, "spectral_conv_2d_plain"),
           (sp, "spectral_conv_2d_packed_plain"),
           (sp, "spectral_dft2d_fwd_spectrum_plain"),
           (sp, "spectral_dft2d_bwd_plain"), (sp, "spectral_weight_grad"),
           (sp, "film_grad_plain")]
    counts = {name: 0 for _, name in fns}
    saved = [(mod, name, getattr(mod, name)) for mod, name in fns]

    def counting(name, fn):
        def run(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return run

    for mod, name, fn in saved:
        setattr(mod, name, counting(name, fn))
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def ns512_train_launches(gn_inputs, depth):
    """The launches of one ns512 train step at ``depth``: every forward call
    of the depth + 1 applies, and each once more in the backward (the
    per-block remat recomputes the K1 and K2 forwards, which are not
    convs), then one backward per call. ``gn_inputs``: the serving step's
    GroupNorm inputs, [shape, dtype, activation, calls per apply]."""
    stream = sum(n for s, _, _, n in gn_inputs if _streams(s))
    persistent = sum(n for s, _, _, n in gn_inputs if not _streams(s))
    want = {"spectral_dft2d_fwd_large": NS_BLOCKS * (depth + 2),
            "gn1_gelu_fwd": persistent * (depth + 2),
            "gn1_gelu_fwd_stream": stream * (depth + 2),
            "spectral_dft2d_bwd_large": NS_BLOCKS,
            "spectral_dw2d": NS_BLOCKS,
            "gn1_gelu_bwd": persistent + stream}
    return {k: v for k, v in want.items() if v}


def ns512_train_argv(tmp, seed, extra=()):
    return ["chip_smoke", f"--dataset.base_path={tmp}/ns512", f"--seed={seed}",
            f"--base_resolution=[{NS_NT},{NS_N},{NS_N}]",
            f"--super_resolution=[{NS_NT},{NS_N},{NS_N}]",
            "--trainer.num_epochs=1",
            "--trainer.test_interval=1", "--trainer.print_interval=1",
            f"--experiment_path={tmp}/out", "--experiment_name=train_ns512",
            *extra]


def _grad_nrmse(got, ref):
    """nRMSE of ``got`` against ``ref`` (two dicts of tensors by parameter
    name: gradients or parameters) over all of them, and the worst
    tensor's (value, name)."""
    num = sum(float(((got[k].float() - r) ** 2).sum()) for k, r in ref.items())
    den = sum(float((r ** 2).sum()) for r in ref.values())
    worst = max((float(((got[k].float() - r) ** 2).mean().sqrt()
                       / (r ** 2).mean().sqrt().clamp_min(1e-30)), k)
                for k, r in ref.items())
    return math.sqrt(num / den), worst


def ns512_train(seed, tmp, out_dir, gn_inputs):
    """Train the full-width cfg_ns512_ufno (bf16, remat save_conv_outputs)
    built by the training CLI's get_config_static on the ns512 split: one
    epoch (its train split's 2 simulations: one step at batch 2; stdout to
    train_ns512.log in ``out_dir``), then steps at batch 8 (the train
    split's samples in turn, start steps drawn by the trainer) timed at
    NS_TRAIN_DEPTHS, their launches against ns512_train_launches and the
    plain versions' calls (none); one depth-0 step again with the U-FNO's
    remat off (its peak memory, or the out-of-memory it raises); one step of
    the same weights in f32 against bf16 at batch 2; the narrow model
    (NS_NARROW, f32) depth-1 step card against CPU; then ns512_accum on the
    same batch. Returns (record, the epoch's launches, the grad_accum
    mini-steps' launches, failures)."""
    import gc

    import numpy as np
    import torch

    from nps_tpu_torch import kernels
    from nps_tpu_torch.data.pipeline import collate, prefetch_to_device
    from nps_tpu_torch.inference import autotuned_convs
    from nps_tpu_torch.models.ufno import UFNO

    argv = ns512_train_argv(tmp, seed)
    trainer = build_trainer(NS_CFG, argv, "cuda")
    failures = []
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with plain_calls() as plain, \
            open(out_dir / "train_ns512.log", "w") as log, \
            contextlib.redirect_stdout(log):
        train_losses, val_losses, _ = trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = with_routes(kernels)
    n_steps = len(trainer.get_dataloaders()[0])
    per_step = ns512_train_launches(gn_inputs, 0)
    want_run = {k: v * n_steps for k, v in per_step.items()
                if k.endswith(("_bwd", "_bwd_large", "_dw2d"))}
    if any(launches.get(k) != v for k, v in want_run.items()) or not all(
            launches.get(k) for k in per_step):
        failures.append(f"ns512 training launches {launches}, want "
                        f"{want_run} and every kernel of {sorted(per_step)}")
    if not (np.isfinite(train_losses).all()
            and np.isfinite(val_losses["default"]).all()):
        failures.append("ns512 training losses are not finite")

    ds = trainer.data.train
    host = collate([ds[i % len(ds)] for i in range(NS_BATCH)])
    batches = prefetch_to_device(iter([host]), trainer.device)
    batch = next(batches)
    batches.close()
    held_before_steps = cuda_held()
    with autotuned_convs(), plain_calls() as plain_steps:
        steps = {d: timed_steps(trainer, batch, d,
                                ns512_train_launches(gn_inputs, d),
                                NS_TRAIN_TIMED, NS_BATCH)
                 for d in NS_TRAIN_DEPTHS}
    if not all(v["launches_ok"] for v in steps.values()):
        failures.append("ns512 train-step launch counts differ from the "
                        "expected")
    if not all(np.isfinite(v["loss"]) for v in steps.values()):
        failures.append("ns512 train-step losses are not finite")
    if any(plain.values()) or any(plain_steps.values()):
        failures.append(f"plain versions called on the card: {plain}, "
                        f"{plain_steps}")

    # one more depth-0 step: its tanh F.gelu calls by caller (one graded
    # apply, whose U-Net final activations the remat recomputes) and its
    # gn1_gelu_bwd calls, then those calls timed together
    with autotuned_convs(), tanh_gelus() as gelus, gn_bwd_calls() as bwds:
        trainer.train_step(batch, 0, 0, unrolled=0)
        torch.cuda.synchronize()
    want_gelus = dict(NS_TANH_PER_APPLY)
    want_gelus["unet_modern.py:forward"] *= 2
    if dict(gelus) != want_gelus:
        failures.append(f"ns512 train step: tanh F.gelu calls {dict(gelus)}"
                        f" (want {want_gelus})")
    if any(a != "tanh" for _, _, a in bwds["calls"]) or bwds["dy_copies"]:
        failures.append(f"ns512 train step: gn1_gelu_bwd activations "
                        f"{sorted({a for _, _, a in bwds['calls']})}, "
                        f"{bwds['dy_copies']} copies of dy")
    GN_BWD_STEP_CALLS["ns512"] = bwds["calls"]
    gn_bwd_step = dict(gn_bwd_step_time(bwds["calls"]),
                       dy_copies=bwds["dy_copies"])
    gc.collect()
    torch.cuda.empty_cache()

    # the same depth-0 step without the U-FNO's remat
    ufnos = [m for m in trainer.model.modules() if isinstance(m, UFNO)]
    gc.collect()
    torch.cuda.empty_cache()
    with autotuned_convs():
        for m in ufnos:
            m.remat = False
        try:
            torch.cuda.reset_peak_memory_stats()
            trainer.train_step(batch, 0, 0, unrolled=0)
            torch.cuda.synchronize()
            no_remat = {"peak_mem_gib": torch.cuda.max_memory_allocated()
                        / 2 ** 30, "out_of_memory": False}
        except torch.cuda.OutOfMemoryError as e:
            no_remat = {"peak_mem_gib": None, "out_of_memory": True,
                        "error": str(e)[:300]}
        finally:
            for m in ufnos:
                m.remat = True
    gc.collect()
    torch.cuda.empty_cache()
    remat_peak = steps[0]["peak_mem_gib"]
    if not (no_remat["out_of_memory"]
            or remat_peak < no_remat["peak_mem_gib"]):
        failures.append(f"remat peak {remat_peak} GiB not below "
                        f"{no_remat['peak_mem_gib']} GiB without remat")

    # the same weights in f32 and in bf16, one depth-0 step at batch 2
    f32 = build_trainer(NS_CFG, ns512_train_argv(
        tmp, seed, ["--trainer.compute_dtype=float32"]), "cuda")
    f32.ensure_initialized()
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    f32.model.load_state_dict(state)
    small = tuple(t[:2] for t in batch)
    steps0 = torch.randint(NS_TW, NS_NT - 2 * NS_TW + 1, (2,),
                           generator=torch.Generator().manual_seed(seed))
    t0 = time.perf_counter()
    with autotuned_convs():
        loss32, _ = f32.train_step(small, 0, 0, unrolled=0, steps0=steps0)
        grads32 = {k: p.grad.float() for k, p in f32.model.named_parameters()}
        loss16, _ = trainer.train_step(small, 0, 0, unrolled=0,
                                       steps0=steps0)
        grads16 = {k: p.grad for k, p in trainer.model.named_parameters()}
        torch.cuda.synchronize()
    f32_s = time.perf_counter() - t0
    loss_dev = abs(float(loss16) - float(loss32)) / abs(float(loss32))
    g_nrmse, g_worst = _grad_nrmse(grads16, grads32)
    vs_f32 = {"batch": 2, "depth": 0, "loss_bf16": float(loss16),
              "loss_f32": float(loss32), "loss_rel_dev": loss_dev,
              "grad_nrmse": g_nrmse, "worst_param_grad_nrmse": g_worst,
              "seconds": f32_s}
    if not loss_dev < NS_TRAIN_F32_TOL:
        failures.append(f"ns512 train step bf16 vs f32: loss {loss_dev}")
    del f32, grads32, grads16, state
    gc.collect()
    torch.cuda.empty_cache()

    # the narrow model, f32: its K1 backward takes the large-plane variant
    narrow = build_trainer(NS_CFG, ns512_train_argv(
        tmp, seed, [*NS_NARROW, "--trainer.compute_dtype=float32"]), "cuda")
    narrow.ensure_initialized()
    kernels.reset_launches()
    with autotuned_convs():
        vs_cpu, loss_err, grad_err = step_vs_cpu(
            NS_CFG, ns512_train_argv(tmp, seed, [
                *NS_NARROW, "--trainer.compute_dtype=float32"]),
            narrow, batch, seed, tw=NS_TW, nt=NS_NT)
    vs_cpu["launches"] = dict(kernels.launches)
    if not (loss_err < REL_TOL_STEP and grad_err < REL_TOL_STEP_GRAD):
        failures.append(f"ns512 narrow train step card vs CPU: {vs_cpu}")
    if not vs_cpu["launches"].get("spectral_dft2d_bwd_large"):
        failures.append(f"ns512 narrow train step launched no "
                        f"spectral_dft2d_bwd_large: {vs_cpu['launches']}")
    rec = {"config": NS_CFG, "batch": NS_BATCH,
           "data_parallel": trainer.config.data_parallel,
           "compute_dtype": str(trainer.compute_dtype),
           "remat": [ufnos[0].remat, ufnos[0].remat_policy],
           "epoch": {"train_steps": n_steps, "seconds": train_s,
                     "train_losses": train_losses,
                     "val_losses": val_losses["default"],
                     "launches": launches, "launches_expected": want_run,
                     "plain_calls": plain},
           "steps": {str(d): v for d, v in steps.items()},
           "held_before_steps": held_before_steps,
           "plain_calls_in_steps": plain_steps,
           "tanh_gelu_calls": dict(gelus),
           "tanh_gelu_calls_expected": want_gelus,
           "gn_bwd_step": gn_bwd_step,
           "no_remat_step": no_remat, "remat_peak_mem_gib": remat_peak,
           "bf16_vs_f32": vs_f32, "narrow_vs_cpu": vs_cpu}
    # the main model's UFNO processor (with its gradients) goes too, also
    # through ``m``, the remat loops' last module, so that the grad_accum
    # run's memory holds only its own trainer
    del trainer, narrow, ufnos, m
    gc.collect()
    torch.cuda.empty_cache()
    rec["grad_accum"], accum_launches, bad = ns512_accum(
        seed, tmp, batch, gn_inputs, steps[0])
    failures += bad
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches, accum_launches, failures


def cuda_held(n=6):
    """What the process holds on the card: the allocated GiB, and the ``n``
    largest CUDA tensors Python still references (GiB, shape, dtype), found
    by the garbage collector (a parameter and its gradient count apart)."""
    import gc
    import warnings

    import torch

    sizes = collections.Counter()
    with warnings.catch_warnings():   # isinstance on deprecated proxies
        warnings.simplefilter("ignore", FutureWarning)
        for obj in gc.get_objects():
            try:
                if isinstance(obj, torch.Tensor) and obj.is_cuda:
                    sizes[(tuple(obj.shape), str(obj.dtype))] += (
                        obj.numel() * obj.element_size())
            except ReferenceError:
                continue
    return {"allocated_gib": torch.cuda.memory_allocated() / 2 ** 30,
            "referenced_gib": sum(sizes.values()) / 2 ** 30,
            "largest": [[b / 2 ** 30, list(s), d]
                        for (s, d), b in sizes.most_common(n)]}


def accum_trainer(argv, device):
    """The cfg_ns512_ufno trainer of ``argv`` at grad_accum=2, its
    optimizer built. The config has no grad_accum key (nor has the JAX
    package's), so the CLI takes no --trainer.grad_accum flag for it: the
    value goes on the trainer's config before the optimizer is built, as
    the JAX package's tests pass it to their trainer."""
    trainer = build_trainer(NS_CFG, argv, device)
    trainer.config.grad_accum = 2
    trainer.ensure_initialized()
    return trainer


def ns512_accum(seed, tmp, batch, gn_inputs, depth0):
    """grad_accum=2 (``accum_trainer``) on the full-width cfg_ns512_ufno
    (bf16, remat, its own ``data_parallel=True``), built by the training
    CLI's get_config_static: two depth-0 mini-steps at batch 8, the launch counts
    set to 0 just before each and read just after (each a depth-0 step's):
    the parameters hold after the first and move at the second; then
    NS_TRAIN_TIMED effective steps of batch 16 (two mini-steps each,
    median after a warm-up, host clock around synchronised steps) with
    their peak memory, beside the batch-8 depth-0 step ``depth0``; then the
    narrow model (NS_NARROW, f32) at grad_accum=2 through one boundary on
    the card and on the CPU, same weights and start steps: each mini-step's
    loss (REL_TOL_STEP), the mean gradient the boundary stepped on
    (REL_TOL_STEP_GRAD) and the parameters after it (nRMSE, REL_TOL_STEP).
    Returns (record, the two mini-steps' launches, failures)."""
    import gc

    import torch

    from nps_tpu_torch import kernels
    from nps_tpu_torch.inference import autotuned_convs
    from nps_tpu_torch.train.optim import MultiSteps

    failures = []
    held_at_entry = cuda_held()
    acc = accum_trainer(ns512_train_argv(tmp, seed), "cuda")
    if not isinstance(acc.optimizer, MultiSteps):
        failures.append(f"grad_accum=2 built {type(acc.optimizer)}")
    params = list(acc.model.parameters())
    p0 = [p.detach().clone() for p in params]
    want = ns512_train_launches(gn_inputs, 0)
    mini = []
    with autotuned_convs(), plain_calls() as plain:
        for i in range(2):
            kernels.reset_launches()
            acc.train_step(batch, 0, i, unrolled=0)
            torch.cuda.synchronize()
            mini.append({"launches": dict(kernels.launches),
                         "params_moved": sum(not torch.equal(a, p)
                                             for a, p in zip(p0, params)),
                         "mini_step_after": acc.optimizer.mini_step})
    del p0
    total = collections.Counter()
    for m in mini:
        total.update(m["launches"])
    if any(m["launches"] != want for m in mini):
        failures.append(f"ns512 grad_accum mini-step launches "
                        f"{[m['launches'] for m in mini]}, want {want}")
    if mini[0]["params_moved"] or not mini[1]["params_moved"]:
        failures.append(f"ns512 grad_accum: {mini[0]['params_moved']} "
                        f"tensors moved after the first mini-step, "
                        f"{mini[1]['params_moved']} after the second")
    if any(plain.values()):
        failures.append(f"plain versions called on the card: {plain}")

    with autotuned_convs():
        for i in range(2):           # warm-up: one effective step
            acc.train_step(batch, 0, i, unrolled=0)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() / 2 ** 30
        held_resident = cuda_held()
        torch.cuda.reset_peak_memory_stats()
        seconds, mini_seconds = [], []
        for i in range(NS_TRAIN_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for j in range(2):
                t1 = time.perf_counter()
                loss, _ = acc.train_step(batch, 0, 2 * i + j, unrolled=0)
                torch.cuda.synchronize()
                mini_seconds.append(time.perf_counter() - t1)
            seconds.append(time.perf_counter() - t0)
    median = sorted(seconds)[len(seconds) // 2]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rec = {"grad_accum": 2, "mini_batch": NS_BATCH,
           "effective_batch": 2 * NS_BATCH, "depth": 0,
           "mini_steps": mini, "launches_expected_per_mini_step": want,
           "plain_calls": plain,
           "effective_step_seconds": seconds,
           "mini_step_seconds": mini_seconds,
           "ms_per_effective_step": 1e3 * median,
           "samples_per_s": 2 * NS_BATCH / median,
           "peak_mem_gib": peak, "resident_gib": resident,
           "held_at_entry": held_at_entry, "held_resident": held_resident,
           "loss": float(loss),
           "batch8_depth0_ms": depth0["ms_per_step"],
           "batch8_depth0_peak_mem_gib": depth0["peak_mem_gib"],
           "batch8_depth0_resident_gib": depth0["resident_gib"],
           "peak_minus_batch8_gib": peak - depth0["peak_mem_gib"]}
    if not math.isfinite(float(loss)):
        failures.append("ns512 grad_accum loss is not finite")
    del acc, params
    gc.collect()
    torch.cuda.empty_cache()

    argv = ns512_train_argv(tmp, seed, [*NS_NARROW,
                                        "--trainer.compute_dtype=float32"])
    card = accum_trainer(argv, "cuda")
    cpu = accum_trainer(argv, "cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               card.model.state_dict().items()})
    small = tuple(t[:2] for t in batch)
    small_cpu = tuple(t.cpu() for t in small)
    gen = torch.Generator().manual_seed(seed)
    losses = []
    with autotuned_convs():
        for i in range(2):
            steps0 = torch.randint(NS_TW, NS_NT - NS_TW + 1, (2,),
                                   generator=gen)
            lg, _ = card.train_step(small, 0, i, unrolled=0, steps0=steps0)
            lc, _ = cpu.train_step(small_cpu, 0, i, unrolled=0,
                                   steps0=steps0)
            losses.append((float(lg), float(lc),
                           abs(float(lg) - float(lc)) / abs(float(lc))))
    grad_err, grad_worst = _grad_errors(
        {k: p.grad for k, p in card.model.named_parameters()},
        {k: p.grad for k, p in cpu.model.named_parameters()})
    # after an Adam step a gradient element at f32 noise level may take the
    # other sign on the two devices and move its parameter by 2 lr the other
    # way: the nRMSE over the model holds it, the worst tensor is recorded
    p_nrmse, p_worst = _grad_nrmse(
        {k: v.cpu() for k, v in card.model.state_dict().items()},
        cpu.model.state_dict())
    rec["narrow_vs_cpu"] = {
        "depth": 0, "batch": 2, "losses_gpu_cpu_rel_err": losses,
        "mean_grad_rel_err": grad_err, "worst_grad": grad_worst,
        "params_nrmse_after_boundary": p_nrmse,
        "worst_param_nrmse": p_worst,
        "mini_step_after": [card.optimizer.mini_step,
                            cpu.optimizer.mini_step]}
    if not (max(e for _, _, e in losses) < REL_TOL_STEP
            and grad_err < REL_TOL_STEP_GRAD and p_nrmse < REL_TOL_STEP):
        failures.append(f"ns512 narrow grad_accum card vs CPU: "
                        f"{rec['narrow_vs_cpu']}")
    del card, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return rec, dict(total), failures


def spectral_bwd_large_record(gen, dtype):
    """spectral_dft2d_bwd at the ns512 input gradient (dy [8, 128, 512,
    512] -> dx [8, 132, 512, 512], NS_MODES x NS_MODES) in ``dtype``: its
    large-plane variant against the plain version (dx at REL_TOL_BF16 in
    bf16, REL_TOL_F32 in f32; G at REL_TOL_F32), twice for the same bits,
    timed (graph replay) beside the plain version, autograd's input
    gradient through rfft2 + einsum + irfft2 (on dy widened to f32), and
    the bound (the operations at the input type's peak; the f32 CUDA-core
    bound apart)."""
    import torch

    from nps_tpu_torch import kernels
    from nps_tpu_torch.ops import spectral as sp

    b, ci, n1, n2 = NS_SPEC_SHAPE
    co, m = NS_HIDDEN, (NS_MODES, NS_MODES)
    dy = torch.randn((b, co, n1, n2), device="cuda", generator=gen).to(dtype)
    ws = [torch.rand((2, ci, co, *m), device="cuda", generator=gen)
          / (ci * co) for _ in range(2)]
    packed = sp.pack_weights_2d(ws)
    kernels.reset_launches()
    got = sp.spectral_dft2d_bwd(dy, packed, m)
    launched = dict(kernels.launches)
    again = sp.spectral_dft2d_bwd(dy, packed, m)
    ref = sp.spectral_dft2d_bwd_plain(dy, packed, m)
    torch.cuda.synchronize()
    err = rel_err(got[0], ref[0])
    err_g = max(rel_err(got[1], ref[1]), rel_err(got[2], ref[2]))
    same = all(torch.equal(a, c) for a, c in zip(got, again))
    x = torch.zeros(NS_SPEC_SHAPE, device="cuda", requires_grad=True)
    w_c = complex_weights(*ws)
    y_l = rfft_conv(x, w_c, m)
    dyf = dy.float()
    err_library = rel_err(torch.autograd.grad(y_l, x, dyf,
                                              retain_graph=True)[0], ref[0])
    flops = spectral_flops(b, co, ci, n1, n2, *m)
    nbytes = (dy.element_size() * (dy.numel() + b * ci * n1 * n2)
              + 4 * (packed.numel() + 2 * got[1].numel()))
    bf16 = dtype == torch.bfloat16
    bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16 if bf16 else PEAK_F32)
    rec = {"phase": "kernel", "name": "spectral_dft2d_bwd_large",
           "dtype": str(dtype), "shape": [[b, co, n1, n2], ci, list(m)],
           "launched": launched, "rel_err": err, "rel_err_spectrum": err_g,
           "same_bits": same, "rel_err_library_vs_plain": err_library,
           "max_abs_err": float((got[0].float() - ref[0].float()).abs().max()),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_f32_ops_ms": flops / PEAK_F32 * 1e3,
           "bound_how": f"dy + dx in {dtype}, the f32 pack read once and G "
                        f"written once at 3.35 TB/s ({nbytes} B); {flops} "
                        f"flop at "
                        f"{'989 TFLOP/s bf16' if bf16 else '67 TFLOP/s f32'}",
           "library_how": "autograd's input gradient through rfft2 + einsum "
                          "+ irfft2 on dy in f32: eager calls between CUDA "
                          "events"}
    del again, ref
    timed(rec, lambda: sp.spectral_dft2d_bwd(dy, packed, m), "ms",
          **FEW_CALLS)
    timed(rec, lambda: sp.spectral_dft2d_bwd_plain(dy, packed, m),
          "plain_ms", **FEW_CALLS)
    rec["library_ms"] = event_ms(lambda: torch.autograd.grad(
        y_l, x, dyf, retain_graph=True), calls=5)
    rec["bound_share"] = bound_ms / rec["ms"] if rec["ms"] else None
    rec["f32_ops_share"] = (rec["bound_f32_ops_ms"] / rec["ms"] if rec["ms"]
                            else None)
    emit(rec)
    tol = REL_TOL_BF16 if bf16 else REL_TOL_F32
    if not (err < tol and err_g < REL_TOL_F32 and same
            and launched == {"spectral_dft2d_bwd_large": 1}):
        raise AssertionError(f"spectral_dft2d_bwd_large ({dtype}): dx {err}, "
                             f"G {err_g}, same bits {same}, {launched}")
    return rec


def gn_bwd_bf16_record(gen, shape, act):
    """gn1_gelu_bwd in bf16 at an ns512 GroupNorm input with the activation
    ``act`` (GN_ACT_KW): dx (bf16) against autograd through the plain
    version at REL_TOL_BF16, dgamma and dbeta (f32) at REL_TOL_GRAD, twice
    for the same bits, timed (graph replay) beside autograd through the
    plain version and through F.group_norm (+ F.gelu) in bf16 (eager calls
    between CUDA events), with the bound (x, dy read once, dx written once),
    the floor of x and dy read twice, and the design's (gn_bwd_design)."""
    import torch
    import torch.nn.functional as F

    from nps_tpu_torch import kernels
    from nps_tpu_torch.ops import group_norm as gn

    c, n = shape[1], math.prod(shape)
    bf = torch.bfloat16
    kw = GN_ACT_KW[act]
    x = (torch.randn(shape, device="cuda", generator=gen) * 1.5 + 0.3).to(bf)
    gamma = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=gen)
    beta = 0.1 * torch.randn(c, device="cuda", generator=gen)
    dy = torch.randn(shape, device="cuda", generator=gen).to(bf)
    _, stats = gn.gn1_gelu_fwd_stats(x, gamma, beta, **kw)
    kernels.reset_launches()
    got = gn.gn1_gelu_bwd(x, gamma, beta, stats, dy, **kw)
    launched = dict(kernels.launches)
    again = gn.gn1_gelu_bwd(x, gamma, beta, stats, dy, **kw)
    y_p, leaves_p, ref = _grads(lambda *t: gn.gn_gelu_plain(*t, **kw),
                                (x, gamma, beta), dy)
    torch.cuda.synchronize()
    err = rel_err(got[0], ref[0])
    err_w = max(rel_err(got[1], ref[1]), rel_err(got[2], ref[2]))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    bound_ms, bound_by = bound(3 * 2 * n, GN_BWD_FLOPS_PER_ELEMENT * n)
    rec = {"phase": "kernel", "name": "gn1_gelu_bwd (bf16, ns512 shape)",
           "shape": list(shape), "dtype": str(bf), "act": act,
           "launched": launched, "rel_err": err, "rel_err_dweight": err_w,
           "same_bits": same,
           "max_abs_err": float((got[0].float() - ref[0].float()).abs().max()),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "two_read_floor_ms": 5 * 2 * n / PEAK_BYTES * 1e3,
           "bound_how": "x, dy read once + dx written once, bf16, at "
                        "3.35 TB/s", **gn_bwd_design(x, dy)}
    del again
    timed(rec, lambda: gn.gn1_gelu_bwd(x, gamma, beta, stats, dy, **kw),
          "ms", **FEW_CALLS)
    rec["plain_ms"] = event_ms(lambda: torch.autograd.grad(
        y_p, leaves_p, dy, retain_graph=True), calls=3)
    del y_p, leaves_p, ref

    def library(x, w, b):
        z = F.group_norm(x, 1, w.to(bf), b.to(bf))
        return z if act == "off" else F.gelu(z, approximate=kw["approximate"])

    y_l, leaves_l, _ = _grads(library, (x, gamma, beta), dy)
    rec["library_ms"] = event_ms(lambda: torch.autograd.grad(
        y_l, leaves_l, dy, retain_graph=True), calls=3)
    rec["bound_share"] = bound_ms / rec["ms"] if rec["ms"] else None
    emit(rec)
    if not (err < REL_TOL_BF16 and err_w < REL_TOL_GRAD and same
            and launched == {"gn1_gelu_bwd": 1}):
        raise AssertionError(f"gn1_gelu_bwd bf16 at {shape}: dx {err}, "
                             f"dweight {err_w}, same bits {same}, {launched}")
    return rec


# each train step's gn1_gelu_bwd calls (shape, dtype, activation), by
# family ("ns512" for cfg_ns512_ufno's), for the profile phase's count of
# the backward's kernels by name
GN_BWD_STEP_CALLS = {}


@contextlib.contextmanager
def gn_bwd_calls():
    """Record every gn1_gelu_bwd call inside the block (shape, dtype,
    activation), and count the GNGeluFn backward calls whose dy was not
    contiguous (its .contiguous() then copies)."""
    from nps_tpu_torch.ops import group_norm as gn

    seen = {"calls": [], "dy_copies": 0}
    bwd, fn_bwd = gn.gn1_gelu_bwd, gn.GNGeluFn.backward

    def record(x, weight, bias, stats, dy, gelu=True, approximate="none"):
        seen["calls"].append((tuple(x.shape), x.dtype,
                              gn_act(gelu, approximate)))
        return bwd(x, weight, bias, stats, dy, gelu, approximate)

    def backward(ctx, dy):
        seen["dy_copies"] += not dy.is_contiguous()
        return fn_bwd(ctx, dy)

    gn.gn1_gelu_bwd = record
    gn.GNGeluFn.backward = staticmethod(backward)
    try:
        yield seen
    finally:
        gn.gn1_gelu_bwd = bwd
        gn.GNGeluFn.backward = staticmethod(fn_bwd)


def gn_bwd_step_time(calls):
    """The gn1_gelu_bwd calls of one train step (``calls``: shape, dtype,
    activation) on fresh inputs, timed together (graph replay) beside their
    summed bound and design floor (gn_bwd_design), with each shape's
    l2_fit and the calls by route."""
    import torch

    from nps_tpu_torch.ops import group_norm as gn

    args, bound_ms, floor_ms, counts = [], 0.0, 0.0, collections.Counter()
    fits, routes = {}, collections.Counter()
    for shape, dtype, act in calls:
        x = torch.randn(shape, device="cuda").to(dtype)
        dy = torch.randn(shape, device="cuda").to(dtype)
        w = torch.ones(shape[1], device="cuda")
        kw = GN_ACT_KW[act]
        _, stats = gn.gn1_gelu_fwd_stats(x, w, torch.zeros_like(w), **kw)
        args.append((x, w, torch.zeros_like(w), stats, dy, kw))
        n, size = math.prod(shape), x.element_size()
        bound_ms += bound(3 * size * n, GN_BWD_FLOPS_PER_ELEMENT * n)[0]
        design = gn_bwd_design(x, dy)
        floor_ms += design["floor_ms"]
        fits[str(list(shape))] = design["l2_fit"]
        routes[design["route"]] += 1
        counts[(shape, str(dtype), act)] += 1

    def run():
        for *a, kw in args:
            gn.gn1_gelu_bwd(*a, **kw)

    rec = {"calls": len(calls), "bound_ms": bound_ms, "floor_ms": floor_ms,
           "l2_fit": fits, "routes": dict(routes),
           "shapes": [[list(s), d, a, k] for (s, d, a), k in
                      sorted(counts.items())]}
    timed(rec, run, "ms", calls=2, replays=3, warmup=1)
    rec["bound_share"] = bound_ms / rec["ms"] if rec["ms"] else None
    del args
    return rec


def phase_ns512_train(seed, card, gen, out_dir, tmp, gn_inputs):
    """The ns512 training slice (ns512_train) on the split phase_ns512
    wrote, then its kernels at the ns512 shapes: the large-plane input
    gradient in bf16 and f32, spectral_dw2d at the ns512 modes, and
    gn1_gelu_bwd in bf16 at the largest and smallest GroupNorm inputs, each
    gelu setting. Returns (the epoch's launches, the grad_accum mini-steps'
    launches, the kernel records by name)."""
    import gc

    import torch

    from nps_tpu_torch.ops import spectral as sp

    t0 = time.perf_counter()
    rec, launches, accum_launches, failures = ns512_train(seed, tmp, out_dir,
                                                          gn_inputs)
    emit({"phase": "ns512_train", **rec, "card": card, "tf32": False})
    if failures:
        raise AssertionError("; ".join(failures))
    recs = {"spectral_dft2d_bwd_large": spectral_bwd_large_record(
        gen, torch.bfloat16)}
    gc.collect()
    recs["spectral_dft2d_bwd_large"]["f32"] = spectral_bwd_large_record(
        gen, torch.float32)
    gc.collect()
    b, ci = NS_SPEC_SHAPE[:2]
    modes = 2 * NS_MODES * NS_MODES
    spectra = [torch.randn((modes, b, c), device="cuda", generator=gen)
               for c in (ci, ci, NS_HIDDEN, NS_HIDDEN)]
    scale = sp.mode_scale(NS_N, NS_N, NS_MODES, NS_MODES, "cuda")
    recs["spectral_dw2d_ns512"] = dw2d_record(*spectra, scale, NS_MODES)
    shapes = [tuple(s) for s, _, _, _ in gn_inputs]
    records = [gn_bwd_bf16_record(gen, shape, act)
               for shape in (max(shapes, key=math.prod),
                             min(shapes, key=math.prod))
               for act in ("tanh", "off")]
    gc.collect()
    torch.cuda.empty_cache()
    recs["gn1_gelu_bwd_bf16"] = dict(records[0], shapes=[
        {k: r[k] for k in ("shape", "act", "launched", "rel_err",
                           "rel_err_dweight", "same_bits", "ms", "plain_ms",
                           "library_ms", "bound_ms", "bound_share")}
        for r in records], step_calls=gn_bwd_measured(rec["gn_bwd_step"]))
    recs["seconds"] = time.perf_counter() - t0
    return launches, accum_launches, recs


def var1d_pde():
    from nps_tpu_torch.pde import PDE1D

    return PDE1D(tmin=0.0, tmax=10.0, nt=V1_T_MAX, L=1.0, nx=V1_NX, x=None,
                 name="var1d", n_cond_static=2)


def var1d_serving_inputs(seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return (rng.random((V1_BATCH, 2, V1_TW, V1_NX), dtype=np.float32),
            rng.random((V1_BATCH, 2), dtype=np.float32))


def phase_var1d(seed, card, out_dir, tmp):
    """The variable-time 1D path, cfg_var1d_fno at full width (2 blocks x
    64 features, 8 modes, time window 5, batch 8): ragged data from the
    port's generator at its config's size (V1_SIMS simulations of 40-100
    frames on 32 points); one training epoch through the training CLI on
    the card (stdout to train_var1d.log in ``out_dir``); train steps on one
    min-cropped batch timed at each admissible depth V1_DEPTHS (median of
    V1_TIMED after a warm-up); one masked max-pad evaluation and one train
    step (depth 1, batch 2) card against CPU; the engine's eager rollout
    of V1_STEPS bundled steps (median of ROLLOUTS) and the captured one
    (median of ROLLOUTS replays, against eager, CAPTURED_TOL). It runs
    neither K1 nor K2 (JAX computes its 1D spectral conv with XLA einsums,
    the port with torch.einsum): every launch count of the phase must stay
    0. Returns the phase's launches (empty)."""
    import gc

    import numpy as np
    import torch

    from nps_tpu_torch import kernels, train_cli
    from nps_tpu_torch.data.pipeline import prefetch_to_device
    from nps_tpu_torch.data.synthetic import generate_var_t
    from nps_tpu_torch.inference import SurrogateEngine, autotuned_convs

    failures = []
    t0 = time.perf_counter()
    generate_var_t(f"{tmp}/var1d_data/var1d", n_sims=V1_SIMS, nx=V1_NX,
                   t_min=V1_T_MIN, t_max=V1_T_MAX, seed=seed)
    gen_s = time.perf_counter() - t0
    argv = ["chip_smoke", "-C", V1_CFG, f"--dataset.base_path={tmp}/var1d_data",
            f"--seed={seed}", "--trainer.num_epochs=1",
            "--trainer.test_interval=1", "--trainer.print_interval=1",
            f"--experiment_path={tmp}/out", "--experiment_name=train_var1d"]
    kernels.reset_launches()
    t0 = time.perf_counter()
    with open(out_dir / "train_var1d.log", "w") as log, \
            contextlib.redirect_stdout(log):
        trainer = train_cli.cli(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    with open(trainer.config.save_path + "_metrics.jsonl") as f:
        metrics = [json.loads(line) for line in f]
    if trainer.device.type != "cuda" or launches:
        failures.append(f"var1d CLI epoch on {trainer.device}, launches "
                        f"{launches}")
    if not (len(metrics) == 1 and np.isfinite(metrics[0]["train_loss"])
            and np.isfinite(metrics[0]["default - val loss"])):
        failures.append(f"var1d CLI epoch metrics {metrics}")

    train_loader, valid_loader, _ = trainer.get_dataloaders()
    host = next(iter(train_loader))
    batch = next(prefetch_to_device(iter([host]), trainer.device))
    t_res = int(batch[1].shape[2])
    with autotuned_convs():
        steps = {d: timed_steps(trainer, batch, d, {}, V1_TIMED, V1_BATCH)
                 for d in V1_DEPTHS if t_res >= V1_TW * (d + 2)}
    if sorted(steps) != list(V1_DEPTHS):
        failures.append(f"var1d batch of {t_res} frames admits depths "
                        f"{sorted(steps)}, want {list(V1_DEPTHS)}")
    if not all(v["launches_ok"] and np.isfinite(v["loss"])
               for v in steps.values()):
        failures.append(f"var1d timed steps: {steps}")

    cpu = build_trainer(V1_CFG, argv[:1] + argv[3:], "cpu")
    cpu.ensure_initialized()
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               trainer.model.state_dict().items()})
    vhost = next(iter(valid_loader))
    vbatch = next(prefetch_to_device(iter([vhost]), trainer.device))
    padded_frames = int(vhost[1].shape[2]) * len(vhost[6]) - int(
        np.sum(vhost[6]))
    with autotuned_convs():
        loss_gpu, _ = trainer.test_step(vbatch, 0)
    loss_cpu, _ = cpu.test_step(tuple(torch.from_numpy(a) for a in vhost), 0)
    eval_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    with autotuned_convs():
        vs_cpu, loss_err, grad_err = step_vs_cpu(
            V1_CFG, argv[:1] + argv[3:], trainer, batch, seed, tw=V1_TW,
            nt=t_res)
    if not (eval_err < REL_TOL_STEP and loss_err < REL_TOL_STEP
            and grad_err < REL_TOL_STEP_GRAD):
        failures.append(f"var1d card vs CPU: eval {eval_err}, {vs_cpu}")

    eng = SurrogateEngine.from_config(V1_CFG, pde=var1d_pde(), device="cuda")
    eng.model.load_state_dict(trainer.model.state_dict())
    u0, cond = var1d_serving_inputs(seed)
    eng.rollout(u0, V1_STEPS, cond=cond)     # warm-up
    kernels.reset_launches()
    seconds = []
    for _ in range(ROLLOUTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.rollout(u0, V1_STEPS, cond=cond)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    out_c = eng.rollout(u0, V1_STEPS, cond=cond, captured=True)
    capture_s = time.perf_counter() - t0
    c_seconds = []
    for _ in range(ROLLOUTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_c = eng.rollout(u0, V1_STEPS, cond=cond, captured=True)
        torch.cuda.synchronize()
        c_seconds.append(time.perf_counter() - t0)
    serve_launches = dict(kernels.launches)
    captured_err = float(np.abs(out_c - out).max() / np.abs(out).max())
    median = sorted(seconds)[len(seconds) // 2]
    c_median = sorted(c_seconds)[len(c_seconds) // 2]
    if tuple(out.shape) != (V1_BATCH, 2, V1_STEPS * V1_TW, V1_NX) or \
            not np.isfinite(out).all():
        failures.append(f"var1d rollout shape {out.shape} or not finite")
    if not captured_err <= CAPTURED_TOL:
        failures.append(f"var1d captured rollout vs eager: {captured_err}")
    if serve_launches:
        failures.append(f"var1d serving launched {serve_launches}")
    rec = {"phase": "var1d", "config": V1_CFG,
           "parameters": sum(p.numel() for p in trainer.model.parameters()),
           "data": {"sims": V1_SIMS, "nx": V1_NX,
                    "t": [V1_T_MIN, V1_T_MAX], "generate_seconds": gen_s},
           "kernels": "none: no K1 or K2 on this path",
           "epoch": {"cli_seconds": cli_s, "metrics": metrics,
                     "train_batches": len(train_loader),
                     "launches": launches},
           "steps": {str(d): v for d, v in steps.items()},
           "step_batch_frames": t_res,
           "eval_vs_cpu": {"loss_gpu": loss_gpu, "loss_cpu": loss_cpu,
                           "rel_err": eval_err,
                           "padded_frames": padded_frames,
                           "lengths": [int(v) for v in vhost[6]]},
           "train_step_vs_cpu": vs_cpu,
           "serve": {"batch": V1_BATCH, "bundled_steps": V1_STEPS,
                     "rollout_seconds": seconds,
                     "bundled_steps_per_s": V1_STEPS / median,
                     "launches": serve_launches,
                     "captured": {"bundled_steps_per_s": V1_STEPS / c_median,
                                  "rollout_seconds": c_seconds,
                                  "capture_seconds": capture_s,
                                  "rel_err_vs_eager": captured_err}},
           "card": card, "tf32": False}
    emit(rec)
    del trainer, cpu, eng, batch, vbatch
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return {**launches, **serve_launches}


# the dp phase: cfg_twophase_ufno at full width in a world of DP_WORLD
# ranks sharing the one card over gloo (NCCL refuses two ranks on one
# device), the config's global batch TRAIN_BATCH, TRAIN_BATCH / DP_WORLD a
# rank, one step at each of TRAIN_DEPTHS from the same weights and starts
# as the single-process step; bars: loss rel DP_LOSS_TOL, gradients the
# backward kernels' REL_TOL_GRAD (per tensor, _grad_errors), ZeRO-1's
# parameters after Adam against unsharded data parallelism's DP_ZERO_TOL;
# a rank that fails or passes DP_TIMEOUT seconds fails the phase and its
# peers are killed. The gradient floor: a tensor whose gradient is below
# DP_GRAD_FLOOR of the model's largest is held at that floor (the last up
# block's shortcut bias, zero in exact arithmetic: the two sum its f32
# noise over the batch in other orders)
DP_WORLD, DP_LOSS_TOL, DP_ZERO_TOL, DP_TIMEOUT = 2, 1e-5, 1e-6, 600
DP_GRAD_FLOOR = 1e-3
# the evaluation (test_step over the whole trajectory, its frames gathered
# over the ranks) against the single-process batch-TRAIN_BATCH one from the
# same weights: the per-step losses (one apply from the ground truth each)
# within DP_LOSS_TOL, the first rollout window's frames within the forward
# bar REL_TOL_STEP. The later windows feed each prediction back in, and
# are read, not held: they show how far batching alone moves the rollout
# (the single process on the ranks' halves against its whole batch)
DP_EVAL_TOL = REL_TOL_STEP


def eval_rollout(trainer, batch, max_test_len=None):
    """``trainer.test_step`` over ``batch`` with its frames (its first
    ``max_test_len``): (info, the predicted frames [b, c, t, *sp] on the
    CPU)."""
    import torch

    _, info, (_, pred, _) = trainer.test_step(
        batch, 0, include_data=True, max_test_len=max_test_len)
    return info, torch.from_numpy(pred)


def eval_errors(info, pred, ref_info, ref_pred):
    """Evaluation against a reference: the largest relative error of the
    per-step losses (teacher-forced), the unrolled loss's, and each
    rollout window's max|d| / max|ref| of the frames."""
    steps = [k for k in ref_info if k.startswith("Step ")]
    window_errs = [float((pred[:, :, s:s + TW] - ref_pred[:, :, s:s + TW])
                         .abs().max() / ref_pred[:, :, s:s + TW].abs().max())
                   for s in range(TW, ref_pred.shape[2], TW)]
    unrolled = "Unrolled forward losses"
    return {"step_loss_rel_err": max(
                abs(info[k] - ref_info[k]) / abs(ref_info[k])
                for k in [*steps, "Mean per-step loss"]),
            "unrolled": info[unrolled],
            "unrolled_rel_err": abs(info[unrolled] - ref_info[unrolled])
            / abs(ref_info[unrolled]),
            "window_rel_err": window_errs}


def run_ranks(commands, logs, timeout, env=None):
    """Start one process per command (output to its log file) and wait for
    all within ``timeout`` seconds; when one fails or the time is up, kill
    the others. ``env``: variables added for every command, or a list of
    them, one per command. Returns the exit codes (None for a rank killed
    at the limit)."""
    return wait_ranks(start_ranks(commands, logs, env), timeout)


def start_ranks(commands, logs, env=None):
    """Start one process per command (output to its log file; ``env`` as
    run_ranks'); returns them. A failure to start kills those started."""
    import os

    envs = env if isinstance(env, list) else [env] * len(commands)
    procs = []
    try:
        for cmd, log, extra in zip(commands, logs, envs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    cmd, stdout=f, stderr=subprocess.STDOUT,
                    cwd=Path(__file__).resolve().parent,
                    env=dict(os.environ, **(extra or {}))))
    except BaseException:
        kill_ranks(procs)
        raise
    return procs


def kill_ranks(procs):
    """Kill every process of ``procs`` still running."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def wait_ranks(procs, timeout):
    """Wait for every process of ``procs`` within ``timeout`` seconds; when
    one fails or the time is up, kill the others. Returns the exit codes
    (None for a rank killed at the limit)."""
    try:
        deadline = time.monotonic() + timeout
        while True:
            # every rank polled (any() would stop at the first running one
            # and miss a later rank's failure)
            codes = [p.poll() for p in procs]
            if (None not in codes or time.monotonic() > deadline
                    or any(c not in (None, 0) for c in codes)):
                break
            time.sleep(0.5)
    finally:
        kill_ranks(procs)
    return [p.returncode for p in procs]


def _tail(path, n=40):
    return "\n".join(Path(path).read_text().splitlines()[-n:])


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dp_worker(spec_path):
    """One rank of the dp phase (``chip_smoke.py --dp-worker SPEC``): join
    the gloo world on the card through the package's init_distributed,
    build the shipped trainer with data_parallel (its batches: this rank's
    slice of the first global batch of the split, from the multi-process
    loader), then from the same weights: a warm-up step, one depth-0 step of
    plain data parallelism (its parameters after Adam, peak memory and
    optimizer-state bytes), and with zero1 one step at each depth (loss and
    gradients against the single-process steps in the spec's reference
    file, launches, the step's ms, and at depth 0 the parameters against
    plain data parallelism's, peak memory and state bytes), then the
    evaluation of the batch (test_step, its frames gathered over the
    ranks; rank 0 holds it against the single-process one). cuDNN times
    only its deterministic algorithms here: the two runs' gradients must
    be the same bits for Adam's first update (about lr times the sign of
    the gradient) to agree where a gradient is near zero. Writes its
    record to the spec's ``out`` as JSON."""
    import gc

    import torch

    from nps_tpu_torch import kernels, parallel
    from nps_tpu_torch.inference import autotuned_convs

    spec = json.loads(Path(spec_path).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = parallel.init_distributed(
        f"tcp://127.0.0.1:{spec['port']}", world_size=spec["world"],
        rank=spec["rank"], backend="gloo", device="cuda",
        timeout=DP_TIMEOUT)
    rank, world = parallel.world()
    ref = torch.load(spec["ref"], weights_only=False)
    b = TRAIN_BATCH // world
    mine = {d: s[rank * b:(rank + 1) * b] for d, s in ref["steps0"].items()}
    rec = {"rank": rank, "world": world, "device": str(device),
           "backend": torch.distributed.get_backend(), "steps": {}}

    def trainer(zero1):
        tr = build_trainer(family_cfg("ufno"), [
            *spec["argv"], "--trainer.data_parallel=true",
            f"--trainer.zero1={zero1}"], device)
        tr.load_model(spec["weights"])
        tr.ensure_initialized()
        return tr

    def step(tr, depth, batch):
        """A step from the reference weights with a fresh optimizer."""
        tr.load_model(spec["weights"])
        tr.set_optimizer(tr.optimizer_spec)
        kernels.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _ = tr.train_step(batch, 0, 0, unrolled=depth,
                                steps0=mine[depth])
        torch.cuda.synchronize()
        return {"loss": float(loss), "ms": 1e3 * (time.perf_counter() - t0),
                "launches": dict(kernels.launches),
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}

    try:
        with autotuned_convs(deterministic=True):
            tr = trainer(False)
            batch = first_batch(tr)
            rec["batch"] = int(batch[1].shape[0])
            step(tr, 0, batch)   # warm-up: cuDNN's timing, the gloo rings
            plain = step(tr, 0, batch)
            dp_params = {k: p.detach().cpu() for k, p in
                         tr.model.named_parameters()}
            rec["plain"] = {"depth0": plain, "optimizer":
                            type(tr.optimizer).__name__,
                            "state_bytes": parallel.state_bytes(tr.optimizer)}
            del tr
            gc.collect()
            torch.cuda.empty_cache()
            tz = trainer(True)
            rec["zero1"] = {"optimizer": type(tz.optimizer).__name__}
            for depth in TRAIN_DEPTHS:
                r = step(tz, depth, batch)
                r["loss_rel_err"] = abs(r["loss"] - ref["loss"][depth]) / abs(
                    ref["loss"][depth])
                r["grad_rel_err"], r["worst_grad"] = _grad_errors(
                    {k: p.grad for k, p in tz.model.named_parameters()},
                    ref["grads"][depth], DP_GRAD_FLOOR)
                if depth == 0:
                    r["params_vs_plain"], r["worst_param"] = max(
                        (float((p.detach().cpu() - dp_params[k]).abs().max())
                         / max(float(dp_params[k].abs().max()), 1e-30), k)
                        for k, p in tz.model.named_parameters())
                    rec["zero1"]["state_bytes"] = parallel.state_bytes(
                        tz.optimizer)
                rec["steps"][str(depth)] = r
            del tz
            gc.collect()
            torch.cuda.empty_cache()
            # the evaluation from the reference weights (data_parallel
            # without zero1: test_step does not read the optimizer)
            te = trainer(False)
            info, pred = eval_rollout(te, batch)
            if rank == 0:
                ev = torch.load(spec["eval_ref"], weights_only=False)
                rec["eval"] = eval_errors(info, pred, ev["info"], ev["pred"])
                rec["eval"]["vs_halves"] = eval_errors(info, pred,
                                                       *ev["halves"])
    finally:
        torch.distributed.destroy_process_group()
    Path(spec["out"]).write_text(json.dumps(rec))
    return 0


def dp_reference(seed, tmp):
    """The single-process batch-TRAIN_BATCH step on the card at each of
    TRAIN_DEPTHS from one set of weights and start steps, and the
    evaluation of the batch from those weights (and of its DP_WORLD
    slices, one at a time: the ranks' shapes): writes the weights,
    {steps0, loss, grads} and the evaluation for the ranks to ``tmp``;
    returns
    (the record, the argv the ranks build their trainers from, the weights'
    path)."""
    import gc

    import torch

    from nps_tpu_torch.inference import autotuned_convs

    argv = train_argv(tmp, seed, 1, "dp_single")
    trainer = build_trainer(family_cfg("ufno"), argv, "cuda")
    trainer.ensure_initialized()
    weights = f"{tmp}/dp_weights.pt"
    torch.save({k: v.detach().cpu() for k, v in
                trainer.model.state_dict().items()}, weights)
    batch = first_batch(trainer)
    gen = torch.Generator().manual_seed(seed + 2)
    ref = {"steps0": {}, "loss": {}, "grads": {}}
    rec = {}
    with autotuned_convs():
        trainer.train_step(batch, 0, 0, unrolled=0)   # warm-up
        for depth in TRAIN_DEPTHS:
            steps0 = torch.randint(TW, TRAIN_NT - TW * (depth + 1) + 1,
                                   (TRAIN_BATCH,), generator=gen)
            trainer.load_model(weights)
            trainer.set_optimizer(trainer.optimizer_spec)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = trainer.train_step(batch, 0, 0, unrolled=depth,
                                         steps0=steps0)
            torch.cuda.synchronize()
            rec[str(depth)] = {"loss": float(loss),
                               "ms": 1e3 * (time.perf_counter() - t0)}
            ref["steps0"][depth] = steps0
            ref["loss"][depth] = float(loss)
            ref["grads"][depth] = {k: p.grad.detach().cpu() for k, p in
                                   trainer.model.named_parameters()}
        trainer.load_model(weights)
        with torch.no_grad():   # the first window's apply (the sp phase's)
            ref["forward"] = trainer._apply(
                batch[1][:, :, :TW], batch[3], None, batch[2], None,
                batch[5]).cpu()
    torch.save(ref, f"{tmp}/dp_ref.pt")
    with autotuned_convs(deterministic=True):
        trainer.load_model(weights)
        info, pred = eval_rollout(trainer, batch)
        h = TRAIN_BATCH // DP_WORLD
        halves = [eval_rollout(trainer, tuple(a[r * h:(r + 1) * h]
                                              for a in batch))
                  for r in range(DP_WORLD)]
    halves = ({k: sum(i[k] for i, _ in halves) / DP_WORLD for k in info},
              torch.cat([p for _, p in halves]))
    rec["eval"] = {"unrolled": info["Unrolled forward losses"],
                   "halves": eval_errors(*halves, info, pred)}
    torch.save({"info": info, "pred": pred, "halves": halves},
               f"{tmp}/dp_eval_ref.pt")
    del trainer, batch, ref, pred, halves
    gc.collect()
    torch.cuda.empty_cache()
    return rec, argv, weights


def dp_cli_nccl(seed, tmp, out_dir):
    """A world of one over NCCL through the training CLI, as torchrun
    launches a rank: --trainer.distributed=auto with WORLD_SIZE=1,
    data_parallel and zero1, one epoch on the split without the epoch's
    validation (the CLI's own evaluations before and after training stay;
    stdout to train_dp_nccl.log in ``out_dir``). Returns (its command, its
    log, its environment, the check of its exit code: fn(rc, seconds) ->
    (record, failures))."""
    import math

    log = out_dir / "train_dp_nccl.log"
    argv = train_argv(tmp, seed, 1, "dp_nccl")[1:]
    cmd = [sys.executable, "-m", "nps_tpu_torch.train_cli", "-C",
           family_cfg("ufno"), *argv, "--trainer.test_interval=99",
           "--trainer.distributed=auto", "--trainer.data_parallel=true",
           "--trainer.zero1=true"]
    env = dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))

    def check(rc, seconds):
        text = log.read_text()
        line = [ln for ln in text.splitlines()
                if ln.startswith("Distributed:")]
        losses = [ln.split(":", 1)[1] for ln in text.splitlines()
                  if ln.startswith("Train losses:")]
        losses = json.loads(losses[-1]) if losses else []
        rec = {"rc": rc, "seconds": seconds, "process_line": line[:1],
               "train_losses": losses}
        failures = []
        if rc != 0:
            failures.append(f"CLI world of one exited {rc}:\n{_tail(log)}")
        elif not (line and "backend nccl" in line[0]):
            failures.append(f"CLI world of one: process line {line}")
        elif len(losses) != 1 or not all(math.isfinite(v) for v in losses):
            failures.append(f"CLI world of one: train losses {losses}")
        return rec, failures

    return cmd, log, env, check


def phase_dp(seed, card, out_dir, tmp):
    """Data parallelism and ZeRO-1 on the main path: (a) DP_WORLD ranks
    sharing the card over gloo (dp_worker) against the single-process step
    (dp_reference); (b) a world of one over NCCL through the CLI
    (dp_cli_nccl), run beside them (the record's seconds are the three
    processes' together). Returns the launches of one rank's zero1 steps
    and the argv its trainers are built from."""
    single, argv, weights = dp_reference(seed, tmp)
    port = _free_port()
    commands, logs, outs = [], [], []
    for rank in range(DP_WORLD):
        spec = Path(tmp) / f"dp_spec{rank}.json"
        outs.append(Path(tmp) / f"dp_rank{rank}.json")
        spec.write_text(json.dumps({
            "rank": rank, "world": DP_WORLD, "port": port, "argv": argv,
            "weights": weights, "ref": f"{tmp}/dp_ref.pt",
            "eval_ref": f"{tmp}/dp_eval_ref.pt", "out": str(outs[-1])}))
        commands.append([sys.executable, str(Path(__file__).resolve()),
                         "--dp-worker", str(spec)])
        logs.append(out_dir / f"dp_rank{rank}.log")
    nccl_cmd, nccl_log, nccl_env, nccl_check = dp_cli_nccl(seed, tmp,
                                                           out_dir)
    t0 = time.perf_counter()
    *rcs, nccl_rc = run_ranks([*commands, nccl_cmd], [*logs, nccl_log],
                              DP_TIMEOUT, [None] * DP_WORLD + [nccl_env])
    seconds = time.perf_counter() - t0
    failures = [f"rank {r} exited {rc}:\n{_tail(log)}"
                for r, (rc, log) in enumerate(zip(rcs, logs)) if rc != 0]
    ranks = [json.loads(o.read_text()) for o in outs] if not failures else []
    nccl, nccl_failures = nccl_check(nccl_rc, seconds)
    failures += nccl_failures
    want = {depth: family_launches(*FAMILIES["ufno"][:2], depth + 1, True)
            for depth in TRAIN_DEPTHS}
    for r in ranks:
        if r["backend"] != "gloo" or r["batch"] != TRAIN_BATCH // DP_WORLD:
            failures.append(f"rank {r['rank']}: {r['backend']}, batch "
                            f"{r['batch']}")
        if (r["plain"]["optimizer"], r["zero1"]["optimizer"]) != (
                "AllReduceGrads", "Zero1"):
            failures.append(f"rank {r['rank']}: optimizers {r['plain']}")
        for depth in TRAIN_DEPTHS:
            s = r["steps"][str(depth)]
            if not (s["loss_rel_err"] <= DP_LOSS_TOL
                    and s["grad_rel_err"] <= REL_TOL_GRAD
                    and s["launches"] == want[depth]):
                failures.append(f"rank {r['rank']} depth {depth}: {s}, "
                                f"launches want {want[depth]}")
        if not r["steps"]["0"]["params_vs_plain"] <= DP_ZERO_TOL:
            failures.append(f"rank {r['rank']}: ZeRO-1 parameters "
                            f"{r['steps']['0']['params_vs_plain']}")
        share = r["zero1"]["state_bytes"] / r["plain"]["state_bytes"]
        if not 0.45 <= share <= 0.55:
            failures.append(f"rank {r['rank']}: ZeRO-1 state share {share}")
    ev = ranks[0]["eval"] if ranks else None
    if ev is not None and not (ev["step_loss_rel_err"] <= DP_LOSS_TOL
                               and ev["window_rel_err"][0] <= DP_EVAL_TOL):
        failures.append(f"evaluation against the single process: {ev}")
    emit({"phase": "dp", "config": family_cfg("ufno"), "world": DP_WORLD,
          "backend": "gloo", "global_batch": TRAIN_BATCH,
          "timing": f"{DP_WORLD} ranks sharing one card: host clock around "
                    "one synchronised step each, cuDNN's deterministic "
                    "algorithms; says nothing about scaling",
          "single_process": single, "seconds": seconds, "ranks": ranks,
          "launches_per_rank_expected": {str(d): w for d, w in want.items()},
          "cli_nccl_world_of_one": nccl, "card": card, "tf32": False})
    if failures:
        raise AssertionError("; ".join(failures))
    return ranks[0]["steps"][str(TRAIN_DEPTHS[-1])]["launches"], argv


# ---- spatial parallelism (the sp phase) --------------------------------------
# Two ranks share the card over gloo (nps_tpu_torch.parallel.spatial: every
# collective is an all_reduce, which gloo carries for CUDA tensors), each
# this script run with --sp-worker, joined by the package's
# init_distributed, a (data, x) grid of D = 1 x K = 2: each rank holds half
# the rows of every field. Bars: the twophase U-FNO (f32, TF32 off) against
# the single-process step on the card from the same weights and starts (the
# dp phase's reference): the forward max|d| / max|ref| <= REL_TOL_STEP, the
# loss rel <= DP_LOSS_TOL, every gradient <= REL_TOL_GRAD (the floor
# DP_GRAD_FLOOR); its evaluation's per-step losses <= DP_LOSS_TOL and first
# rollout window <= DP_EVAL_TOL; the sharded engine's SP_ENGINE_STEPS
# bundled steps against one device's, nRMSE < SP_NRMSE; cfg_ns512_ufno as
# shipped (bf16, remat) against its single-process bf16 step: the loss rel
# <= BF16_FLOOR and the gradients' nRMSE <= NS_F32_TOL (the bound the bf16
# step's own deviation from f32 is held to). The split stages against their
# plain versions at the two configs' local shapes: f32 within REL_TOL_F32
# (forward) and REL_TOL_GRAD (backward), bf16 within REL_TOL_BF16.
SP_K, SP_TIMEOUT, SP_ENGINE_STEPS, SP_NRMSE = 2, 480, 8, 1e-3
# each split entry, the TPU kernel it is a stage of, and the op it serves
SP_ENTRIES = {
    "spectral_split_dft": ("nps_tpu/ops/pallas/spectral_dft.py:144 (git "
                           "92d7866^): stage A, the partial spectrum of the "
                           "local rows (forward; on dy in the backward)"),
    "spectral_split_mix": ("nps_tpu/ops/pallas/spectral_dft.py:144 (git "
                           "92d7866^): the mix (forward) and the adjoint mix "
                           "(backward, _pallas_bwd :175)"),
    "spectral_split_inv": ("nps_tpu/ops/pallas/spectral_dft.py:144 (git "
                           "92d7866^): stage B's inverse to the local rows "
                           "(forward; to dx in the backward)"),
    "gn1_split_sums": ("tools/pallas_group_norm_evidence.py:61: the split "
                       "forward's sums"),
    "gn1_split_apply": ("tools/pallas_group_norm_evidence.py:61: the split "
                        "forward's statistics and normalisation"),
    "gn1_split_bwd_sums": ("tools/pallas_group_norm_evidence.py:106 "
                           "(_gn_bwd, XLA): the split backward's sums"),
    "gn1_split_bwd_apply": ("tools/pallas_group_norm_evidence.py:106 "
                            "(_gn_bwd, XLA): the split backward's dx")}
# the local shapes at K = 2: the twophase U-FNO's spectral input [16, 196,
# 48 of 96 rows, 64] -> 192 (f32, 10 modes) and its largest GroupNorm input
# [16, 388, 50 of 100, 68] (erf GELU); cfg_ns512_ufno's spectral input [8,
# 132, 256 of 512, 512] -> 128 (bf16, 20 modes) and its largest GroupNorm
# input [8, 260, 263 of 526, 526] (the top of the up path; tanh GELU). The
# window is rank 1's (r0 = the rows before it)
SP_SHAPES = {
    "twophase": dict(spec=(TRAIN_BATCH, SPEC_CI, NX1 // 2, NX2), n1=NX1,
                     co=HIDDEN, modes=(MODES, MODES), dtype="float32",
                     gn=(TRAIN_BATCH, 2 * HIDDEN + 4, 50, 68), act="erf"),
    "ns512": dict(spec=(NS_BATCH, NS_HIDDEN + 4, NS_N // 2, NS_N), n1=NS_N,
                  co=NS_HIDDEN, modes=(NS_MODES, NS_MODES), dtype="bfloat16",
                  gn=(NS_BATCH, 2 * NS_HIDDEN + 4, 263, 526), act="tanh"),
    # the time-conditioned U-FNO's: 8 more channels (the BC encoder's code)
    "tcond": dict(spec=(TRAIN_BATCH, SPEC_CI + 8, NX1 // 2, NX2), n1=NX1,
                  co=HIDDEN, modes=(MODES, MODES), dtype="float32",
                  gn=(TRAIN_BATCH, 2 * HIDDEN + 12, 50, 68), act="erf")}
# the sp world's other families (besides the U-FNO and ns512), each from
# one process's weights and starts on the card: name -> (config,
# overrides, depths, the split entries its steps launch; every other entry
# must stay at 0). The MoE takes the ep phase's weights and reference
# (grid_reference: the same config, batch and depths); the MP-GNN and the
# 1D model run whole on each x rank (no row fetched, nothing summed over
# the x group, no split entry)
SP_SPECTRAL = ("spectral_split_dft", "spectral_split_mix",
               "spectral_split_inv")
SP_GN = ("gn1_split_sums", "gn1_split_apply", "gn1_split_bwd_sums",
         "gn1_split_bwd_apply")
SP_FAMILIES = {
    "moe": (family_cfg("moe"), [], (0, 1), SP_SPECTRAL),
    "ufno_tcond": (*P13A["ufno_tcond"][:2], (0, 1), SP_SPECTRAL + SP_GN),
    "unet_attn": (*P13A["unet_attn"][:2], (0, 1), SP_GN),
    "gnn": (family_cfg("gnn"), [], (0,), ()),
    "var1d": (V1_CFG, [], (0,), ())}
SP_WHOLE = {"gnn": "the MP-GNN (a graph)", "var1d": "a 1D model"}
# the MP-GNN whole on each of two ranks at batch 16 holds ~29 GiB a rank:
# it runs in the main sp world after ns512, once the grid ranks have ended
SP_HEAVY = ("gnn",)
SP_GRID_KEYS = {"data_parallel": True, "spatial_parallel": SP_K}
# simulate() on the row-split U-FNO: the first SP_SIM_B elements of the
# batch from their first window over SP_SIM_T frames (5 bundled steps)
SP_SIM_B, SP_SIM_T = 4, 6 * TW


def _modes_first_plain(re, im):
    from nps_tpu_torch.ops.spectral import _modes_first

    return _modes_first(re), _modes_first(im)


def _stage(fn, plain, err, nbytes, flops, peak, **graph):
    """One split stage's record: its error against the plain version, its
    device time, the plain version's, and its bound."""
    rec = {"max_abs_err": err}
    timed(rec, fn, "ms", **graph)
    timed(rec, plain, "plain_ms", **graph)
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, peak)
    rec["bound_share"] = rec["bound_ms"] / rec["ms"] if rec["ms"] else None
    rec["library_ms"] = None
    return rec


def sp_spectral_records(gen, shape):
    """The three K1 split entries (stage A, the mix and the adjoint mix,
    the inverse) at one local shape, each against its plain version on the
    same inputs (``ops/spectral.py``: _spectrum_plain and _inverse_plain of
    the window, the mixes in modes-first layout)."""
    import torch

    from nps_tpu_torch.ops import spectral as sp

    s = SP_SHAPES[shape]
    dtype = getattr(torch, s["dtype"])
    (b, ci, nl, n2), n1, co, (m1, m2) = s["spec"], s["n1"], s["co"], \
        s["modes"]
    r0, k = n1 - nl, 2 * m1
    modes, nm = (m1, m2), k * m2
    x = torch.randn((b, ci, nl, n2), device="cuda", generator=gen).to(dtype)
    w = [0.05 * torch.randn((2, ci, co, m1, m2), device="cuda", generator=gen)
         for _ in range(2)]
    wp = sp.pack_weights_2d(w)
    var_f, var_b = sp._split_check(x, wp, modes, n1)
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
    itemsize = x.element_size()
    tol = REL_TOL_BF16 if dtype == torch.bfloat16 else REL_TOL_F32
    out = {"shape": shape, "variant": var_f, "window": [r0, nl, n1],
           "dtype": s["dtype"]}

    xs = sp.spectral_split_dft(x, modes, n1, r0, var_f)
    ref = torch.stack(_modes_first_plain(*sp._spectrum_plain(x, modes,
                                                             (n1, r0))))
    out["spectral_split_dft"] = _stage(
        lambda: sp.spectral_split_dft(x, modes, n1, r0, var_f),
        lambda: sp._spectrum_plain(x, modes, (n1, r0)), rel_err(xs, ref),
        itemsize * x.numel() + 8 * nm * b * ci,
        b * ci * (nl * n2 * m2 * 4 + nl * k * m2 * 8), peak)

    def mix_plain(xr, xi, adjoint=False):
        if adjoint:
            return sp.adjoint_mix_plain(wp, xr, xi)
        wr, wi = wp[:, 0], wp[:, 1]
        ein = torch.einsum
        return (ein("mbi,mio->mbo", xr, wr) - ein("mbi,mio->mbo", xi, wi),
                ein("mbi,mio->mbo", xr, wi) + ein("mbi,mio->mbo", xi, wr))

    yr, yi, _ = sp.spectral_split_mix(xs[0], xs[1], wp, modes)
    ref = mix_plain(xs[0], xs[1])
    mix_bytes = 4 * (2 * nm * b * (ci + co) + 2 * nm * ci * co)
    out["spectral_split_mix"] = _stage(
        lambda: sp.spectral_split_mix(xs[0], xs[1], wp, modes),
        lambda: mix_plain(xs[0], xs[1]),
        max(rel_err(yr, ref[0]), rel_err(yi, ref[1])), mix_bytes,
        8 * nm * b * ci * co, PEAK_F32)
    g = torch.randn((2, nm, b, co), device="cuda", generator=gen)
    hr, hi, _ = sp.spectral_split_mix(g[0].clone(), g[1].clone(), wp, modes,
                                      adjoint=True)
    ref = mix_plain(g[0], g[1], adjoint=True)
    out["spectral_split_mix"]["adjoint"] = _stage(
        lambda: sp.spectral_split_mix(g[0], g[1], wp, modes, adjoint=True),
        lambda: mix_plain(g[0], g[1], adjoint=True),
        max(rel_err(hr, ref[0]), rel_err(hi, ref[1])), mix_bytes,
        8 * nm * b * ci * co, PEAK_F32)

    o = sp.spectral_split_inv(yr, yi, modes, n1, r0, nl, n2, dtype, var_f)

    def inv_plain():
        y_re, y_im = (t.reshape(k, m2, b, co).permute(2, 3, 0, 1)
                      for t in (yr, yi))
        return sp._inverse_plain(y_re, y_im, (nl, n2), modes, (n1, r0))

    out["spectral_split_inv"] = _stage(
        lambda: sp.spectral_split_inv(yr, yi, modes, n1, r0, nl, n2, dtype,
                                      var_f),
        inv_plain, rel_err(o, inv_plain()),
        8 * nm * b * co + itemsize * b * co * nl * n2,
        b * co * (k * nl * m2 * 8 + nl * n2 * m2 * 4), peak)
    bad = [f"{name} {out[name]['max_abs_err']}" for name in
           ("spectral_split_dft", "spectral_split_mix", "spectral_split_inv")
           if not out[name]["max_abs_err"] <= tol]
    if not out["spectral_split_mix"]["adjoint"]["max_abs_err"] <= REL_TOL_F32:
        bad.append("spectral_split_mix (adjoint)")
    return out, bad


def sp_gn_records(gen, shape):
    """The four K2 split entries at one local shape against their plain
    versions, the sums taken over this slab alone (a world of one: the
    split then equals the whole op): the sums against gn_split_sums_plain,
    the apply against gn_gelu_plain, the backward pair's dx, dweight and
    dbias against autograd through gn_gelu_plain."""
    import torch

    from nps_tpu_torch.ops import group_norm as gn

    s = SP_SHAPES[shape]
    dtype = getattr(torch, s["dtype"])
    kw = GN_ACT_KW[s["act"]]
    act = gn._act(kw["gelu"], kw["approximate"])
    shp = s["gn"]
    c, n = shp[1], math.prod(shp)
    count = math.prod(shp[1:])
    x = (torch.randn(shp, device="cuda", generator=gen) * 1.5 + 0.3).to(dtype)
    w = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=gen)
    bias = 0.1 * torch.randn(c, device="cuda", generator=gen)
    dy = torch.randn(shp, device="cuda", generator=gen).to(dtype)
    bf16 = dtype == torch.bfloat16
    tol_f = REL_TOL_BF16 if bf16 else REL_TOL_F32
    tol_b = REL_TOL_BF16 if bf16 else REL_TOL_GRAD
    it = x.element_size()
    out = {"shape": shape, "gn_shape": list(shp), "dtype": s["dtype"],
           "act": s["act"]}
    sums = gn.gn1_split_sums(x)
    out["gn1_split_sums"] = _stage(
        lambda: gn.gn1_split_sums(x), lambda: gn.gn_split_sums_plain(x),
        rel_err(sums, gn.gn_split_sums_plain(x)), it * n, 3 * n, PEAK_F32,
        **FEW_CALLS)
    y, stats = gn.gn1_split_apply(x, sums, count, w, bias, act)
    out["gn1_split_apply"] = _stage(
        lambda: gn.gn1_split_apply(x, sums, count, w, bias, act),
        lambda: gn.gn_split_apply_plain(x, sums, count, w, bias, **kw),
        rel_err(y, gn.gn_gelu_plain(x, w, bias, **kw)), 2 * it * n,
        GN_FLOPS_PER_ELEMENT * n, PEAK_F32, **FEW_CALLS)
    coef, dw, db = gn.gn1_split_bwd_sums(x, dy, w, bias, stats, count, act)
    dx = gn.gn1_split_bwd_apply(x, dy, w, bias, stats, coef, act)
    _, _, ref = _grads(lambda *a: gn.gn_gelu_plain(*a, **kw), (x, w, bias),
                       dy)
    errs = [rel_err(a, r) for a, r in zip((dx, dw, db), ref)]
    def plain_bwd():
        return _grads(lambda *a: gn.gn_split_apply_plain(
            a[0], gn.gn_split_sums_plain(a[0]), count, *a[1:], **kw),
            (x, w, bias), dy)

    # the plain backward is autograd through the plain stages, forward
    # and backward at once: eager calls between CUDA events, its time
    # under both backward entries
    plain_ms = event_ms(plain_bwd, calls=3, warmup=1)
    for name, err, nbytes in (("gn1_split_bwd_sums", max(errs[1:]),
                               2 * it * n),
                              ("gn1_split_bwd_apply", errs[0], 3 * it * n)):
        fn = ((lambda: gn.gn1_split_bwd_sums(x, dy, w, bias, stats, count,
                                             act))
              if name.endswith("sums") else
              (lambda: gn.gn1_split_bwd_apply(x, dy, w, bias, stats, coef,
                                              act)))
        out[name] = _stage(fn, fn, err, nbytes,
                           GN_BWD_FLOPS_PER_ELEMENT // 2 * n, PEAK_F32,
                           **FEW_CALLS)
        out[name]["plain_ms"] = plain_ms
        out[name]["plain"] = ("autograd through gn_split_sums_plain and "
                              "gn_split_apply_plain, forward and backward, "
                              "eager between CUDA events")
    bad = [f"{name} {out[name]['max_abs_err']}" for name, tol in (
        ("gn1_split_sums", REL_TOL_F32), ("gn1_split_apply", tol_f),
        ("gn1_split_bwd_sums", tol_b), ("gn1_split_bwd_apply", tol_b))
        if not out[name]["max_abs_err"] <= tol]
    del x, dy, y, dx
    return out, bad


def sp_stage_records(gen):
    """Every split entry against its plain version at each local shape;
    returns {entry: its record at the twophase shape, with the ns512 and
    the time-conditioned ones under "ns512" and "tcond"} and the
    failures."""
    import gc

    import torch

    recs, failures = {}, []
    for shape in SP_SHAPES:
        spec, bad = sp_spectral_records(gen, shape)
        failures += [f"{shape}: {b}" for b in bad]
        gnr, bad = sp_gn_records(gen, shape)
        failures += [f"{shape}: {b}" for b in bad]
        emit({"phase": "sp_kernels", "shape": shape, "spectral": spec,
              "gn": gnr})
        for name in SP_ENTRIES:
            r = spec.get(name) or gnr.get(name)
            where = SP_SHAPES[shape]["spec" if name.startswith("spectral")
                                     else "gn"]
            if shape == "twophase":
                recs[name] = dict(r, shape=where)
            else:
                recs[name][shape] = dict(r, shape=where)
        gc.collect()
        torch.cuda.empty_cache()
    return recs, failures


def sp_step(tr, batch, depth, steps0, weights):
    """One step of an sp rank from the reference weights with a fresh
    optimizer: loss, host ms around it (synchronised), the launches and
    the collectives counted in it, peak memory."""
    import torch

    from nps_tpu_torch import kernels
    from nps_tpu_torch.parallel import spatial

    tr.load_model(weights)
    tr.set_optimizer(tr.optimizer_spec)
    kernels.reset_launches()
    spatial.traffic.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, _ = tr.train_step(batch, 0, 0, unrolled=depth, steps0=steps0)
    torch.cuda.synchronize()
    return {"loss": float(loss), "ms": 1e3 * (time.perf_counter() - t0),
            "launches": dict(kernels.launches),
            "traffic": dict(spatial.traffic),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def sp_simulate(tr, batch):
    """``tr.simulate()`` of the first SP_SIM_B elements of the whole
    ``batch`` (numpy, as a user passes them) from their first window over
    SP_SIM_T frames: (losses, frames)."""
    import numpy as np

    u, x, cond, sc = (batch[i][:SP_SIM_B].cpu().numpy() for i in (1, 2, 3, 5))
    losses, (_, pred) = tr.simulate(u, cond, x, compute_loss=True,
                                    include_data=True, nr_gt_steps=1,
                                    t_res=SP_SIM_T, spatial_conditioning=sc)
    return np.asarray(losses), pred


def sp_family(name, paths, device, seed):
    """One family of SP_FAMILIES on this rank's (data, x) grid: the
    trainer the CLI builds with spatial_parallel=SP_K, its rows of the
    first batch, one step at each of its depths from the reference's
    weights and starts (loss, gradients against the reference's,
    launches, collectives); for the attention U-Net the engine's shard(2)
    rollout of SP_ENGINE_STEPS bundled steps against one device's."""
    import gc

    import numpy as np
    import torch

    from nps_tpu_torch import kernels
    from nps_tpu_torch.inference import SurrogateEngine
    from nps_tpu_torch.parallel import spatial

    cfg, over, depths, _ = SP_FAMILIES[name]
    ref = torch.load(paths["ref"], weights_only=False)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        tr = build_trainer(cfg, paths["argv"], device, SP_GRID_KEYS)
    tr.load_model(paths["weights"])
    tr.ensure_initialized()
    batch = tr.grid.shard_batch(first_batch(tr))
    rec = {"whole": tr.grid.whole, "log": log.getvalue().strip(),
           "rows": int(batch[1].shape[3]), "steps": {}}
    for depth in depths:
        r = sp_step(tr, batch, depth, ref["steps0"][depth], paths["weights"])
        r["loss_rel_err"] = abs(r["loss"] - ref["loss"][depth]) / abs(
            ref["loss"][depth])
        r["grad_rel_err"], r["worst_grad"] = _grad_errors(
            {k: p.grad for k, p in tr.model.named_parameters()},
            ref["grads"][depth], DP_GRAD_FLOOR)
        rec["steps"][str(depth)] = r
    del tr, batch, ref
    gc.collect()
    torch.cuda.empty_cache()
    if name == "unet_attn":
        eng = SurrogateEngine.from_config(cfg, overrides=over,
                                          pde=twophase_pde(), device=device)
        eng.load(paths["weights"]).shard(SP_K)
        u0, cond, sc = serving_inputs(seed)
        kernels.reset_launches()
        spatial.traffic.clear()
        t0 = time.perf_counter()
        frames = eng.rollout(u0, SP_ENGINE_STEPS, cond=cond, spatial_cond=sc)
        want = np.load(paths["engine_ref"])
        rec["engine"] = {"seconds": time.perf_counter() - t0,
                         "launches": dict(kernels.launches),
                         "traffic": dict(spatial.traffic),
                         "nrmse": float(np.linalg.norm(frames - want)
                                        / np.linalg.norm(want))}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return rec


def wait_for(paths, limit):
    """Wait until every one of ``paths`` exists, at most ``limit`` seconds;
    returns the seconds waited."""
    t0 = time.perf_counter()
    deadline = time.monotonic() + limit
    while (not all(Path(p).exists() for p in paths)
           and time.monotonic() < deadline):
        time.sleep(0.5)
    return time.perf_counter() - t0


def wait_go(path, limit):
    """Wait for the file ``path`` (phase_worlds writes it once every
    reference is), at most ``limit`` seconds; returns the seconds waited,
    raises at the limit."""
    waited = wait_for([path], limit)
    if not Path(path).exists():
        raise RuntimeError(f"no {path} after {limit} s: the references "
                           f"did not end")
    return waited


def sp_main(spec, rec, device, flags):
    """The sp world's main part: the twophase U-FNO from the dp phase's
    weights and starts (the first window's forward, a warm-up step, one
    step at each of TRAIN_DEPTHS, the evaluation of the batch, held by
    rank 0); last, once the grid phases' ranks have written their records
    (their peaks and these would not fit the card together),
    cfg_ns512_ufno as shipped (one depth-0 step at NS_BATCH), then the
    families of SP_HEAVY (sp_family)."""
    import gc

    import torch

    from nps_tpu_torch.data.pipeline import collate, prefetch_to_device

    ref = torch.load(spec["ref"], weights_only=False)
    tr = build_trainer(family_cfg("ufno"), [*spec["argv"], *flags], device)
    tr.load_model(spec["weights"])
    tr.ensure_initialized()
    batch = tr.grid.shard_batch(first_batch(tr))
    rec["rows"] = int(batch[1].shape[3])
    with torch.no_grad():
        fwd = tr.grid.gather_frames(tr._apply(
            batch[1][:, :, :TW], batch[3], None, batch[2], None, batch[5]))
    rec["forward_rel_err"] = rel_err(fwd, ref["forward"].cuda())
    sp_step(tr, batch, 0, ref["steps0"][0], spec["weights"])  # warm-up
    rec["steps"] = {}
    for depth in TRAIN_DEPTHS:
        r = sp_step(tr, batch, depth, ref["steps0"][depth], spec["weights"])
        r["loss_rel_err"] = abs(r["loss"] - ref["loss"][depth]) / abs(
            ref["loss"][depth])
        r["grad_rel_err"], r["worst_grad"] = _grad_errors(
            {k: p.grad for k, p in tr.model.named_parameters()},
            ref["grads"][depth], DP_GRAD_FLOOR)
        rec["steps"][str(depth)] = r
    tr.load_model(spec["weights"])
    info, pred = eval_rollout(tr, batch)
    if rec["rank"] == 0:
        ev = torch.load(spec["eval_ref"], weights_only=False)
        rec["eval"] = eval_errors(info, pred, ev["info"], ev["pred"])
    del tr, batch, ref
    gc.collect()
    torch.cuda.empty_cache()

    rec["ns512_waited_s"] = wait_for(spec["after"], SP_TIMEOUT)
    ns_ref = torch.load(spec["ns_ref"], weights_only=False)
    ns = build_trainer(NS_CFG, [*spec["ns_argv"], *flags], device)
    ns.load_model(spec["ns_weights"])
    ns.ensure_initialized()
    ds = ns.data.train
    host = collate([ds[i % len(ds)] for i in range(NS_BATCH)])
    batches = prefetch_to_device(iter([host]), device)
    nsb = ns.grid.shard_batch(next(batches))
    batches.close()
    sp_step(ns, nsb, 0, ns_ref["steps0"], spec["ns_weights"])  # warm-up
    r = sp_step(ns, nsb, 0, ns_ref["steps0"], spec["ns_weights"])
    r["loss_rel_err"] = abs(r["loss"] - ns_ref["loss"]) / abs(ns_ref["loss"])
    r["grad_nrmse"], r["worst_grad_nrmse"] = _grad_nrmse(
        {k: p.grad.cpu() for k, p in ns.model.named_parameters()},
        ns_ref["grads"])
    r["batch"] = NS_BATCH
    r["compute_dtype"] = str(ns.compute_dtype)
    rec["ns512"] = r
    del ns, nsb, batches, host
    gc.collect()
    torch.cuda.empty_cache()
    rec["families"] = {}
    for name in SP_HEAVY:
        t0 = time.perf_counter()
        rec["families"][name] = sp_family(name, spec["families"][name],
                                          device, spec["seed"])
        rec["families"][name]["seconds"] = time.perf_counter() - t0


def sp_others(spec, rec, device, flags):
    """The sp world's other part: simulate() of a cut of the U-FNO's first
    batch on its row-split trainer (the whole inputs given), the sharded
    engine's rollout, each family of SP_FAMILIES but SP_HEAVY
    (sp_family), and last each rank's artifact exported from a sharded
    engine (sp_export)."""
    import gc

    import numpy as np
    import torch

    from nps_tpu_torch import kernels
    from nps_tpu_torch.inference import SurrogateEngine

    tr = build_trainer(family_cfg("ufno"), [*spec["argv"], *flags], device)
    tr.load_model(spec["weights"])
    kernels.reset_launches()
    t0 = time.perf_counter()
    losses, frames = sp_simulate(tr, first_batch(tr))
    launches = dict(kernels.launches)
    seconds = time.perf_counter() - t0
    sim_ref = torch.load(spec["sim_ref"], weights_only=False)
    rec["simulate"] = {
        "seconds": seconds, "launches": launches,
        "shape": list(frames.shape),
        "loss_rel_err": float(np.max(np.abs(losses - sim_ref[0])
                                     / np.abs(sim_ref[0]))),
        "nrmse": float(np.linalg.norm(frames - sim_ref[1])
                       / np.linalg.norm(sim_ref[1]))}
    del tr, frames
    gc.collect()
    torch.cuda.empty_cache()

    eng = SurrogateEngine.from_config(family_cfg("ufno"), pde=twophase_pde(),
                                      device=device)
    eng.load(spec["weights"]).shard(SP_K)
    u0, cond, sc = serving_inputs(spec["seed"])
    kernels.reset_launches()
    t0 = time.perf_counter()
    frames = eng.rollout(u0, SP_ENGINE_STEPS, cond=cond, spatial_cond=sc)
    rec["engine"] = {"seconds": time.perf_counter() - t0,
                     "launches": dict(kernels.launches)}
    try:
        eng.rollout(u0, 1, cond=cond, spatial_cond=sc, captured=True)
        rec["engine"]["captured"] = None
    except NotImplementedError as e:
        rec["engine"]["captured"] = str(e)
    want = np.load(spec["engine_ref"])
    rec["engine"]["nrmse"] = float(np.linalg.norm(frames - want)
                                   / np.linalg.norm(want))
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    rec["families"] = {}
    for name in SP_FAMILIES:
        if name in SP_HEAVY:
            continue
        t0 = time.perf_counter()
        rec["families"][name] = sp_family(name, spec["families"][name],
                                          device, spec["seed"])
        rec["families"][name]["seconds"] = time.perf_counter() - t0
    # last: torch.export keeps the constants it traced alive for the rest
    # of the process
    rec["export"] = sp_export(spec, device)


def sp_export(spec, device):
    """``export_rollout`` from a sharded engine of the U-FNO (the dp
    weights): every rank shards two engines, shard(SP_K) and shard(0)
    (collectives), then rank 0 exports the first and rank 1 the second,
    each alone (an export makes no collective), loads its artifact and
    rolls it out SP_ENGINE_STEPS steps on the card: held against the
    unsharded eager rollout (EXPORT_RTOL, EXPORT_ATOL), its wrappers' K1
    and K2 launches against the path's, the collectives the export made
    counted."""
    import gc

    import numpy as np
    import torch

    from nps_tpu_torch import kernels
    from nps_tpu_torch.inference import SurrogateEngine, load_exported
    from nps_tpu_torch.parallel import spatial

    engines = [SurrogateEngine.from_config(
        family_cfg("ufno"), pde=twophase_pde(), device=device).load(
            spec["weights"]).shard(k) for k in (SP_K, 0)]
    k = (SP_K, 0)[spec["rank"]]
    eng = engines[spec["rank"]]
    u0, cond, sc = serving_inputs(spec["seed"])
    path = str(Path(spec["out"]).with_suffix(".npst"))
    spatial.traffic.clear()
    t0 = time.perf_counter()
    eng.export_rollout(path, SP_ENGINE_STEPS, u0, cond=cond, spatial_cond=sc)
    rec = {"shard": k, "export_seconds": time.perf_counter() - t0,
           "traffic": dict(spatial.traffic)}
    del engines, eng
    art = load_exported(path)
    art.rollout(u0, cond=cond, spatial_cond=sc)   # warm-up: cuDNN's timing
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = art.rollout(u0, cond=cond, spatial_cond=sc)
    torch.cuda.synchronize()
    want = np.load(spec["engine_ref"])
    rec.update(rollout_seconds=time.perf_counter() - t0,
               launches=dict(kernels.launches),
               launches_expected=family_launches(*FAMILIES["ufno"][:2],
                                                 SP_ENGINE_STEPS, False),
               allclose=bool(frames.shape == want.shape and np.allclose(
                   frames, want, rtol=EXPORT_RTOL, atol=EXPORT_ATOL)),
               max_abs_err=float(np.abs(frames - want).max()))
    del art
    gc.collect()   # the loaded program holds reference cycles
    torch.cuda.empty_cache()
    return rec


def sp_worker(spec_path):
    """One rank of an sp world (``chip_smoke.py --sp-worker SPEC``): join
    the gloo world on the card, build trainers with data_parallel and
    spatial_parallel=2 (a grid of D = 1 x K = 2), run the spec's part
    (sp_main or sp_others; two worlds of two ranks each, beside the grid
    phases' ranks) and write its record as JSON, with the wall-clock
    times it started and ended."""
    import torch

    from nps_tpu_torch import parallel
    from nps_tpu_torch.inference import autotuned_convs

    started = time.time()
    spec = json.loads(Path(spec_path).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = parallel.init_distributed(
        f"tcp://127.0.0.1:{spec['port']}", world_size=spec["world"],
        rank=spec["rank"], backend="gloo", device="cuda",
        timeout=SP_TIMEOUT)
    flags = ["--trainer.data_parallel=true",
             f"--trainer.spatial_parallel={SP_K}"]
    rec = {"rank": parallel.world()[0], "device": str(device),
           "backend": torch.distributed.get_backend()}
    try:
        rec["go_waited_s"] = wait_go(spec["go"], SP_TIMEOUT)
        with autotuned_convs(deterministic=True):
            (sp_main if spec["part"] == "main" else sp_others)(
                spec, rec, device, flags)
    finally:
        torch.distributed.destroy_process_group()
    rec["clock_" + spec["part"]] = [started, time.time()]
    Path(spec["out"]).write_text(json.dumps(rec))
    return 0


def sp_engine_reference(seed, tmp):
    """The engine's SP_ENGINE_STEPS-step rollout from the dp weights on one
    device, which the sp ranks' sharded rollout is held to."""
    import numpy as np

    from nps_tpu_torch.inference import SurrogateEngine

    eng = SurrogateEngine.from_config(family_cfg("ufno"), pde=twophase_pde(),
                                      device="cuda")
    eng.load(f"{tmp}/dp_weights.pt")
    u0, cond, sc = serving_inputs(seed)
    np.save(f"{tmp}/sp_engine_ref.npy",
            eng.rollout(u0, SP_ENGINE_STEPS, cond=cond, spatial_cond=sc))


def sp_ns512_reference(seed, tmp):
    """One depth-0 step of cfg_ns512_ufno as shipped at NS_BATCH on one
    device (after a warm-up, from the weights it saves: loss, gradients,
    ms, peak memory). Returns the record."""
    import gc

    import torch

    from nps_tpu_torch.data.pipeline import collate, prefetch_to_device
    from nps_tpu_torch.inference import autotuned_convs

    ns = build_trainer(NS_CFG, ns512_train_argv(tmp, seed), "cuda")
    ns.ensure_initialized()
    weights = f"{tmp}/sp_ns_weights.pt"
    torch.save({k: v.detach().cpu() for k, v in
                ns.model.state_dict().items()}, weights)
    ds = ns.data.train
    host = collate([ds[i % len(ds)] for i in range(NS_BATCH)])
    batches = prefetch_to_device(iter([host]), ns.device)
    batch = next(batches)
    batches.close()
    steps0 = torch.randint(NS_TW, NS_NT - NS_TW + 1, (NS_BATCH,),
                           generator=torch.Generator().manual_seed(seed + 3))
    with autotuned_convs(deterministic=True):
        ns.train_step(batch, 0, 0, unrolled=0, steps0=steps0)   # warm-up
        ns.load_model(weights)
        ns.set_optimizer(ns.optimizer_spec)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _ = ns.train_step(batch, 0, 0, unrolled=0, steps0=steps0)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    rec = {"loss": float(loss), "ms": ms, "batch": NS_BATCH,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    ref = {"steps0": steps0, "loss": float(loss),
           "grads": {k: p.grad.detach().float().cpu() for k, p in
                     ns.model.named_parameters()}}
    del ns, batch, batches
    gc.collect()
    torch.cuda.empty_cache()
    torch.save(ref, f"{tmp}/sp_ns_ref.pt")
    return rec


def sp_family_paths(seed, tmp, ep_paths):
    """{family: its argv, weights and reference paths} of SP_FAMILIES: the
    MoE's the ep phase's (``ep_paths``), the others' written by
    sp_family_references."""
    paths = {"moe": dict(ep_paths)}
    for name, (_, over, _, _) in SP_FAMILIES.items():
        if name == "moe":
            continue
        if name == "var1d":
            argv = ["chip_smoke", f"--dataset.base_path={tmp}/sp_var1d",
                    f"--seed={seed}", f"--experiment_path={tmp}/out",
                    "--experiment_name=sp_var1d_single"]
        else:
            argv = [*train_argv(tmp, seed, 1, f"sp_{name}_single"), *over]
        paths[name] = {"argv": argv, "weights": f"{tmp}/sp_{name}_weights.pt",
                       "ref": f"{tmp}/sp_{name}_ref.pt"}
    paths["unet_attn"]["engine_ref"] = f"{tmp}/sp_unet_attn_engine.npy"
    return paths


def sp_family_references(seed, tmp, dp_argv, paths):
    """The one-process references of the sp worlds' other cases, on the
    card: simulate() of the U-FNO from the dp weights (sp_simulate); then
    for each family of SP_FAMILIES but the MoE (whose reference is the ep
    phase's) its weights drawn from the seed, one step at each of its
    depths from start steps drawn from the seed (loss, gradients), and for
    the attention U-Net the engine's SP_ENGINE_STEPS rollout
    (cfg_var1d_fno on a ragged split of its own, as the var1d phase
    generates it). ``paths``: sp_family_paths."""
    import gc

    import numpy as np
    import torch

    from nps_tpu_torch.data.synthetic import generate_var_t
    from nps_tpu_torch.inference import SurrogateEngine, autotuned_convs

    tr = build_trainer(family_cfg("ufno"), dp_argv, "cuda")
    tr.load_model(f"{tmp}/dp_weights.pt")
    with autotuned_convs(deterministic=True):
        sim = sp_simulate(tr, first_batch(tr))
    torch.save(sim, f"{tmp}/sp_sim_ref.pt")
    del tr
    generate_var_t(f"{tmp}/sp_var1d/var1d", n_sims=V1_SIMS, nx=V1_NX,
                   t_min=V1_T_MIN, t_max=V1_T_MAX, seed=seed)
    gen = torch.Generator().manual_seed(seed + 5)
    for name, (cfg, over, depths, _) in SP_FAMILIES.items():
        if name == "moe":
            continue
        mine = paths[name]
        tr = build_trainer(cfg, mine["argv"], "cuda")
        tr.ensure_initialized()
        torch.save({k: v.detach().cpu() for k, v in
                    tr.model.state_dict().items()}, mine["weights"])
        batch = first_batch(tr)
        with autotuned_convs(deterministic=True):
            ref = reference_steps(tr, batch, depths, mine["weights"], gen)
            del tr, batch
            if name == "unet_attn":
                eng = SurrogateEngine.from_config(
                    cfg, overrides=over, pde=twophase_pde(), device="cuda")
                eng.load(mine["weights"])
                u0, cond, sc = serving_inputs(seed)
                frames = eng.rollout(u0, SP_ENGINE_STEPS, cond=cond,
                                     spatial_cond=sc)
                np.save(mine["engine_ref"], frames)
                del eng
        torch.save(ref, mine["ref"])
        gc.collect()
        torch.cuda.empty_cache()


def reference_steps(tr, batch, depths, weights, gen):
    """One process's steps that a world's ranks are held to: a step at each
    of ``depths`` from ``weights`` and a fresh optimizer, from start steps
    drawn from ``gen`` for the batch: {"steps0", "loss", "grads" (zeros
    where a parameter has none, the attention block's unused norm, as the
    ranks' gradient sums give them)}, and the batch, parameter bytes and
    optimizer-state bytes, beside a rank's."""
    import torch

    from nps_tpu_torch import parallel

    b, t_res = int(batch[1].shape[0]), int(batch[1].shape[2])
    ref = {"steps0": {}, "loss": {}, "grads": {}}
    for depth in depths:
        steps0 = torch.randint(tr.tw, t_res - tr.tw * (depth + 1) + 1, (b,),
                               generator=gen)
        tr.load_model(weights)
        tr.set_optimizer(tr.optimizer_spec)
        loss, _ = tr.train_step(batch, 0, 0, unrolled=depth, steps0=steps0)
        ref["steps0"][depth] = steps0
        ref["loss"][depth] = float(loss)
        ref["grads"][depth] = {k: g.cpu() for k, g in
                               tr.whole_grads().items()}
    ref.update(batch=b, param_bytes=sum(p.numel() * p.element_size()
                                        for p in tr.model.parameters()),
               state_bytes=parallel.state_bytes(tr.optimizer))
    return ref


def sp_check(ranks, rcs, logs, single, seconds, card):
    """The sp ranks held as the module note says; prints the sp line and
    the per-rank lines; returns the failures."""
    failures = [f"sp rank {r} exited {rc}:\n{_tail(log)}"
                for r, (rc, log) in enumerate(zip(rcs, logs)) if rc != 0]
    for r in ranks:
        if r["backend"] != "gloo" or r["rows"] != NX1 // SP_K:
            failures.append(f"rank {r['rank']}: {r['backend']}, rows "
                            f"{r['rows']}")
        if not r["forward_rel_err"] <= REL_TOL_STEP:
            failures.append(f"rank {r['rank']}: forward "
                            f"{r['forward_rel_err']}")
        for depth in TRAIN_DEPTHS:
            s = r["steps"][str(depth)]
            unlaunched = [k for k in SP_ENTRIES if not s["launches"].get(k)]
            if not (s["loss_rel_err"] <= DP_LOSS_TOL
                    and s["grad_rel_err"] <= REL_TOL_GRAD and not unlaunched):
                failures.append(f"rank {r['rank']} depth {depth}: {s}; not "
                                f"launched: {unlaunched}")
        e = r["engine"]
        if not (e["nrmse"] < SP_NRMSE and e["captured"]
                and "ROADMAP §2" in e["captured"]):
            failures.append(f"rank {r['rank']}: engine {e}")
        x = r["export"]
        if not (x["allclose"] and x["traffic"] == {}
                and x["launches"] == x["launches_expected"]):
            failures.append(f"rank {r['rank']}: export from shard("
                            f"{x['shard']}) {x}")
        sim = r["simulate"]
        unlaunched = [k for k in ("spectral_split_dft", "spectral_split_inv",
                                  "gn1_split_sums", "gn1_split_apply")
                      if not sim["launches"].get(k)]
        if not (sim["nrmse"] < SP_NRMSE and sim["loss_rel_err"] < SP_NRMSE
                and sim["shape"][3] == NX1 and not unlaunched):
            failures.append(f"rank {r['rank']}: simulate {sim}; not "
                            f"launched: {unlaunched}")
        for name, f in r["families"].items():
            want = SP_FAMILIES[name][3]
            whole = SP_WHOLE.get(name)
            if f["whole"] != whole or (whole is None) != (
                    f["rows"] == NX1 // SP_K) or (
                    whole and "whole on each x rank" not in f["log"]):
                failures.append(f"rank {r['rank']} {name}: whole "
                                f"{f['whole']}, rows {f['rows']}, log "
                                f"{f['log']!r}")
            for depth, s in f["steps"].items():
                wrong = [k for k in SP_ENTRIES
                         if bool(s["launches"].get(k)) != (k in want)]
                moved = whole and s["traffic"]
                attn = name == "unet_attn" and not s["traffic"].get("max")
                if not (s["loss_rel_err"] <= DP_LOSS_TOL
                        and s["grad_rel_err"] <= REL_TOL_GRAD
                        and not wrong and not moved and not attn):
                    failures.append(
                        f"rank {r['rank']} {name} depth {depth}: {s}; "
                        f"launches off their share: {wrong}")
            e = f.get("engine")
            if e and not (e["nrmse"] < SP_NRMSE
                          and all(e["launches"].get(k)
                                  for k in ("gn1_split_sums",
                                            "gn1_split_apply"))):
                failures.append(f"rank {r['rank']} {name}: engine {e}")
        n = r["ns512"]
        unlaunched = [k for k in SP_ENTRIES if not n["launches"].get(k)]
        if not (n["loss_rel_err"] <= BF16_FLOOR
                and n["grad_nrmse"] <= NS_F32_TOL and not unlaunched):
            failures.append(f"rank {r['rank']}: ns512 {n}; not launched: "
                            f"{unlaunched}")
    ev = ranks[0].get("eval") if ranks else None
    if ev is not None and not (ev["step_loss_rel_err"] <= DP_LOSS_TOL
                               and ev["window_rel_err"][0] <= DP_EVAL_TOL):
        failures.append(f"evaluation against the single process: {ev}")
    emit({"phase": "sp", "config": family_cfg("ufno"), "k": SP_K,
          "data_slices": 1, "backend": "gloo", "global_batch": TRAIN_BATCH,
          "families": {name: {"config": cfg, "overrides": over,
                              "depths": list(depths),
                              "split_entries": list(want),
                              "whole_on_each_x_rank": SP_WHOLE.get(name)}
                       for name, (cfg, over, depths, want)
                       in SP_FAMILIES.items()},
          "simulate": {"elements": SP_SIM_B, "frames": SP_SIM_T},
          "timing": f"two worlds of {SP_K} ranks (the U-FNO's steps, "
                    "evaluation and ns512; simulate, the engine and the "
                    "other families) sharing one card with the grid "
                    "phases' ranks: host clock around one synchronised "
                    "step each, cuDNN's deterministic algorithms; says "
                    "nothing about scaling",
          "single_process": single, "seconds": seconds, "ranks": ranks,
          "card": card, "tf32": False})
    for r in ranks:
        fam = {name: {d: (round(s["ms"], 1),
                          {k: s["launches"].get(k, 0) for k in SP_ENTRIES
                           if s["launches"].get(k)})
                      for d, s in f["steps"].items()}
               for name, f in r["families"].items()}
        print(f"sp rank {r['rank']} (two ranks sharing one card): twophase "
              f"step ms " + ", ".join(
                  f"depth {d} {r['steps'][str(d)]['ms']:.1f}"
                  for d in TRAIN_DEPTHS)
              + f"; ns512 step ms {r['ns512']['ms']:.1f}; halo and sum "
              f"bytes per step {r['steps'][str(TRAIN_DEPTHS[-1])]['traffic']}"
              f"; peak GiB twophase "
              f"{r['steps'][str(TRAIN_DEPTHS[-1])]['peak_mem_gib']:.2f}, "
              f"ns512 {r['ns512']['peak_mem_gib']:.2f} (one process "
              f"{single['ns512']['peak_mem_gib']:.2f}); launches per rank "
              f"{ {k: r['steps'][str(TRAIN_DEPTHS[-1])]['launches'].get(k, 0) for k in SP_ENTRIES} }"
              f"; the other families (depth: ms, split launches) {fam}; "
              f"whole on each x rank: "
              f"{ {n: f['whole'] for n, f in r['families'].items() if f['whole']} }",
              flush=True)
    return failures


def phase_worlds(seed, card, gen, out_dir, tmp, dp_argv):
    """Spatial parallelism and the tp, ep and pp phases in one batch of
    ranks: the split stages against their plain versions
    (sp_stage_records); the one-process references of every world
    (sp_engine_reference, sp_ns512_reference, grid_reference,
    sp_family_references, case_reference, and the dp phase's); then two
    sp worlds of SP_K ranks (sp_worker: sp_main and sp_others, side by
    side) and the grid phases' 7 ranks (grid_worker, each with its
    phase's model cases) at once, all sharing the card over gloo; then
    each world held to its references (sp_check, grid_check). Returns
    (the sp U-FNO's depth-8 step launches on rank 0, the split entries'
    records, each grid phase's and model case's rank-0 launches at its
    last depth, the kernel records at the cases' new shapes, the seconds
    of the references and of the ranks). The ranks start before the
    references (their interpreters, imports, CUDA contexts and gloo
    rendezvous, ~25 s under 11 ranks at once, overlap them) and wait for
    the file ``go``, written once every reference is."""
    t0 = time.perf_counter()
    kern, failures = sp_stage_records(gen)
    grid_paths_ = {name: grid_paths(name, seed, tmp, dp_argv)
                   for name in GRID}
    fam_paths = sp_family_paths(seed, tmp, grid_paths_["ep"])
    cases = case_paths(seed, tmp, fam_paths)
    go = Path(tmp) / "worlds_go"
    grid_cmds, grid_logs, grid_outs = {}, {}, {}
    for name, paths in grid_paths_.items():
        port = _free_port()
        grid_cmds[name], grid_logs[name], grid_outs[name] = [], [], []
        for rank in range(GRID[name]["k"]):
            spec = Path(tmp) / f"{name}_spec{rank}.json"
            grid_outs[name].append(Path(tmp) / f"{name}_rank{rank}.json")
            spec.write_text(json.dumps({
                "phase": name, "rank": rank, "port": port, "seed": seed,
                "out": str(grid_outs[name][-1]), "go": str(go), **paths,
                "cases": {c: cases[c] for _, c in GRID_CASES[name]}}))
            grid_cmds[name].append([sys.executable,
                                    str(Path(__file__).resolve()),
                                    "--grid-worker", str(spec)])
            grid_logs[name].append(out_dir / f"{name}_rank{rank}.log")
    after = [str(o) for outs in grid_outs.values() for o in outs]
    sp_cmds, sp_logs, sp_outs = [], [], {}
    for part, tag in (("main", "sp"), ("others", "sp_others")):
        port = _free_port()
        sp_outs[part] = []
        for rank in range(SP_K):
            spec = Path(tmp) / f"{tag}_spec{rank}.json"
            sp_outs[part].append(Path(tmp) / f"{tag}_rank{rank}.json")
            spec.write_text(json.dumps({
                "part": part, "rank": rank, "world": SP_K, "port": port,
                "seed": seed, "argv": dp_argv,
                "weights": f"{tmp}/dp_weights.pt", "ref": f"{tmp}/dp_ref.pt",
                "eval_ref": f"{tmp}/dp_eval_ref.pt",
                "engine_ref": f"{tmp}/sp_engine_ref.npy",
                "ns_argv": ns512_train_argv(tmp, seed),
                "ns_weights": f"{tmp}/sp_ns_weights.pt",
                "ns_ref": f"{tmp}/sp_ns_ref.pt",
                "sim_ref": f"{tmp}/sp_sim_ref.pt", "families": fam_paths,
                "after": after, "go": str(go),
                "out": str(sp_outs[part][-1])}))
            sp_cmds.append([sys.executable, str(Path(__file__).resolve()),
                            "--sp-worker", str(spec)])
            sp_logs.append(out_dir / f"{tag}_rank{rank}.log")
    procs = start_ranks(sp_cmds + [c for n in GRID for c in grid_cmds[n]],
                        sp_logs + [lg for n in GRID for lg in grid_logs[n]])
    try:
        sp_engine_reference(seed, tmp)
        single = {"ns512": sp_ns512_reference(seed, tmp)}
        phases = {name: (paths, grid_reference(name, seed, paths))
                  for name, paths in grid_paths_.items()}
        sp_family_references(seed, tmp, dp_argv, fam_paths)
        seconds = {"case_references": {}}
        for name, case in CASES.items():
            if case.get("ref") != "sp":
                t1 = time.perf_counter()
                case_reference(name, seed, cases[name])
                seconds["case_references"][name] = time.perf_counter() - t1
    except BaseException:
        kill_ranks(procs)
        raise
    seconds["references"] = time.perf_counter() - t0
    go.touch()
    launched = time.time()
    t1 = time.perf_counter()
    rcs = wait_ranks(procs, max(SP_TIMEOUT, GRID_TIMEOUT))
    seconds["ranks"] = time.perf_counter() - t1
    n_sp = 2 * SP_K
    sp_rcs, rcs = rcs[:n_sp], rcs[n_sp:]
    ranks = []
    if all(rc == 0 for rc in sp_rcs):
        # each rank's records of the two worlds, as one
        for m, o in zip(sp_outs["main"], sp_outs["others"]):
            main, others = (json.loads(f.read_text()) for f in (m, o))
            families = {**others.pop("families"), **main.pop("families")}
            ranks.append(dict(main, **others, families={
                name: families[name] for name in SP_FAMILIES}))
    grid_ends = [json.loads(Path(o).read_text())["clock"][1]
                 for o in after if Path(o).exists()]
    seconds["ended"] = {
        "sp_main": max((r["clock_main"][1] for r in ranks), default=None),
        "sp_others": max((r["clock_others"][1] for r in ranks),
                         default=None),
        "grids": max(grid_ends, default=None)}
    seconds["ended"] = {k: None if v is None else v - launched
                        for k, v in seconds["ended"].items()}
    failures += sp_check(ranks, sp_rcs, sp_logs, single, seconds, card)
    launches, case_kern = {}, {}
    for name, (_, grid_single) in phases.items():
        mine, rcs = rcs[:GRID[name]["k"]], rcs[GRID[name]["k"]:]
        got, got_kern, bad = grid_check(name, card, gen, grid_single,
                                        grid_logs[name], grid_outs[name],
                                        mine, seconds["ranks"], cases)
        launches.update(got)
        for kernel, recs in got_kern.items():
            case_kern.setdefault(kernel, {}).update(recs)
        failures += [f"{name}: {f}" for f in bad]
    if failures:
        raise AssertionError("; ".join(failures))
    r0 = ranks[0]
    for name, r in kern.items():
        r["launches_by_path"] = {
            "sp_twophase_depth8": r0["steps"][str(TRAIN_DEPTHS[-1])][
                "launches"].get(name, 0),
            "sp_ns512": r0["ns512"]["launches"].get(name, 0),
            "sp_engine": r0["engine"]["launches"].get(name, 0),
            "sp_simulate": r0["simulate"]["launches"].get(name, 0),
            **{f"sp_{fam}_depth{d}": s["launches"].get(name, 0)
               for fam, f in r0["families"].items()
               for d, s in f["steps"].items()},
            "sp_unet_attn_engine": r0["families"]["unet_attn"]["engine"][
                "launches"].get(name, 0)}
    return (r0["steps"][str(TRAIN_DEPTHS[-1])]["launches"], kern, launches,
            case_kern, {k: v for k, v in seconds.items() if k != "ended"})


# ---- tensor, expert and pipeline parallelism (the tp, ep and pp phases) ----
# Each phase: K ranks sharing the card over gloo (every collective of
# parallel.tensor, .expert and .pipeline is an all_reduce, which gloo
# carries for CUDA tensors), each this script run with --grid-worker, a
# (data, axis) grid of D = 1 x K, the trainer the CLI builds with
# data_parallel and the phase's key, at full width and batch TRAIN_BATCH.
# Bars, against one process on the card from the same weights and starts
# (grid_reference; tp and pp from the dp phase's weights): the loss rel
# <= DP_LOSS_TOL, every gradient (gathered whole) <= REL_TOL_GRAD above
# DP_GRAD_FLOOR of the largest; each rank's K1 and K2 launches (its
# wrappers' counts, and the kernels counted by name with torch.profiler in
# a forward apply) equal to its share of the path
# (grid_launches); both kernel ops against their plain versions at every
# shape a rank's steps gave them (check_shapes). tp also evaluates the
# first TP_EVAL_B elements of the batch over TP_EVAL_T frames (test_step:
# per-step losses <= DP_LOSS_TOL, the first window <= DP_EVAL_TOL).
# After its phase's own steps each rank runs the phase's model cases
# (GRID_CASES) to the same bars.
TP_K, EP_K, PP_K, PP_MICRO = 2, 2, 3, 4
GRID_TIMEOUT = 600
# tp moves every split layer's output through host memory (gloo): a
# depth-0 step of two ranks on one card takes 20-50 s, a depth-1 one 40-70
# s and the whole batch's evaluation ~9 s a window (PERF.md), so tp takes
# no warm-up step (its first step's ms includes cuDNN's algorithm search),
# steps the U-FNO at depth 0 (its depth-1 path is the time-conditioned
# U-FNO case's, 8 channels wider) and evaluates 2 elements over 2
# windows (~40 s, most of it cuDNN timing the convs at their shapes; the
# whole batch took ~70 s); pp steps at depths 0 and 2 (one block a stage:
# depth 8 adds 6 more pipelined no-grad applies of the same stages)
TP_DEPTHS, TP_EVAL_B, TP_EVAL_T = (0,), 2, 2 * TW
EP_DEPTHS, PP_DEPTHS = (0, 1), (0, 2)
GRID = {"tp": dict(cfg="ufno", key="tensor_parallel", k=TP_K,
                   depths=TP_DEPTHS, flags=[]),
        "ep": dict(cfg="moe", key="expert_parallel", k=EP_K,
                   depths=EP_DEPTHS, flags=[]),
        "pp": dict(cfg="ufno", key="pipeline_parallel", k=PP_K,
                   depths=PP_DEPTHS,
                   flags=[f"--trainer.pipeline_microbatches={PP_MICRO}"])}
# the model cases (ROADMAP P9b's model-axis remainders), each at full
# width against one process on the card: name -> its config, overrides,
# parsed-config entries, depths and reference ("sp": the sp world's
# reference of the same family, weights and starts: sp_family_references;
# "own": case_reference). The MP-GNN runs whole on each tp rank at batch
# GNN_TP_BATCH: at batch 16 two ranks would hold ~29 GiB each beside the
# other ranks. The U-FNO's mini U-Nets take attention on their lower level
# and in the middle: on the 100 x 68 level a block's f32 scores alone are
# 16 x 6800^2 x 4 B = 3 GB. A list of PP_K attention U-Nets is one stage a
# processor. The 3D models are D3_HIDDEN features, D3_CASE_BLOCKS blocks
# (K = 3 stages under pp), D3_MODES modes, on D3_GRID at batch D3_BATCH
# (the MoE 4 experts a block), the trainer of cfg_twophase_ufno taking
# them through model_override on a generated batch of D3_CASE_NT frames.
# GRID_CASES: each phase's ranks -> their cases, each (its regime, its
# name): the ep world's 2 ranks, idle once their own cases end, take the
# attention U-Net's tp case and the tp cases of the 3D models too (a
# (data, model) grid of 1 x 2 on the same world; 2-5 GiB a rank), and then
# the 3D models under spatial parallelism ("sp": a (data, x) grid of 1 x
# SP_K, D3_GRID's 64 rows split 32 a rank, SP_CASE), beside the tp ranks'
# longer cases. The MP-GNN's tp case (10 GiB a rank) stays last on the tp
# ranks: run by the ep ranks beside the others' peaks it ran the card out
# of memory.
GNN_TP_BATCH, D3_CASE_BLOCKS, D3_CASE_NT = 4, 3, 3 * D3_TW
SP_CASE = dict(key="spatial_parallel", k=SP_K)
GRID_CASES = {"tp": (("tp", "ufno_tcond"), ("tp", "gnn")),
              "ep": (("ep", "moe_bc"), ("ep", "moe3d"), ("tp", "unet_attn"),
                     ("tp", "fno3d"), ("tp", "drn3d"), ("sp", "fno3d"),
                     ("sp", "drn3d"), ("sp", "moe3d")),
              "pp": (("pp", "ufno_attn"), ("pp", "unet_attn_list"),
                     ("pp", "fno3d"), ("pp", "drn3d"))}
CASES = {
    "ufno_tcond": dict(cfg=P13A["ufno_tcond"][0], ref="sp", depths=(0, 1)),
    "unet_attn": dict(cfg=P13A["unet_attn"][0], ref="sp", depths=(0,)),
    "gnn": dict(cfg=family_cfg("gnn"), over=[f"--batch_size={GNN_TP_BATCH}"],
                depths=(0,)),
    "moe_bc": dict(cfg=family_cfg("moe"), updates={
        "dataset": {"t_conditioning": "t_conditioning"},
        "model": {"bc_encoder": dict(object="BCEncoder", bc_encoder_out=8,
                                     bc_encoder_hidden=32,
                                     bc_encoder_kernel=3,
                                     bc_encoder_n_hidden=1)}},
        depths=(0, 1)),
    "ufno_attn": dict(cfg=family_cfg("ufno"), over=[
        "--model.is_attn=[False,True]", "--model.mid_attn=true"],
        depths=(0, 1)),
    "unet_attn_list": dict(cfg=P13A["unet_attn"][0], over=P13A[
        "unet_attn"][1], updates={"model": {
            "processor": [dict(object="UNetModern")] * PP_K,
            "processor_residual": True}}, depths=(0,)),
    "fno3d": dict(d3=dict(processor="FNO", fno_modes=D3_MODES),
                  depths=(0, 1)),
    "drn3d": dict(d3=dict(processor="DilatedResnet", kernel_size=3,
                          padding_mode="circular"), depths=(0, 1)),
    "moe3d": dict(d3=dict(processor="MoEFNO", n_experts=4,
                          fno_modes=D3_MODES), depths=(0, 1)),
}


def grid_launches(name, depth):
    """One rank's K1 and K2 launches in a step at ``depth``: under tp the
    path's own (K1 on the rank's output channels, K2 on whole
    activations), under ep K1 once for each of the rank's experts, under
    pp its stage's kernels once for each microbatch."""
    gn, spec = FAMILIES["ufno"][:2]
    if name == "tp":
        return family_launches(gn, spec, depth + 1, True)
    if name == "ep":
        return family_launches(0, FAMILIES["moe"][1] // EP_K, depth + 1,
                               True)
    per = PP_MICRO * BLOCKS // PP_K   # (block, microbatch) pairs an apply
    return family_launches(gn // BLOCKS * per, spec // BLOCKS * per,
                           depth + 1, True)


def case_launches(name, depth):
    """One rank's K1 and K2 launches in a model case's step at ``depth``:
    the time-conditioned U-FNO's and the attention U-Net's whole path on
    each tp rank, the attention U-FNO's as the U-FNO's under pp (attention
    launches neither), one attention U-Net of the list a pp rank over
    PP_MICRO microbatches, half the MoE's experts an ep rank; none for the
    MP-GNN and the 3D models under any regime (dense layers, Conv3d,
    torch.fft; no split entry under sp)."""
    if name in ("ufno_tcond", "unet_attn"):
        gn, spec = P13A[name][2][:2]
        return family_launches(gn, spec, depth + 1, True)
    if name == "ufno_attn":
        return grid_launches("pp", depth)
    if name == "unet_attn_list":
        return family_launches(P13A["unet_attn"][2][0] * PP_MICRO, 0,
                               depth + 1, True)
    if name == "moe_bc":
        return grid_launches("ep", depth)
    return {}


def case_model(name, seed):
    """A 3D case's EncProcDec on the D3 PDE, or None for a 2D case."""
    spec = CASES[name].get("d3")
    if spec is None:
        return None
    from nps_tpu_torch.models.enc_proc_dec import EncProcDec
    from nps_tpu_torch.pde import PDE3D

    n1, n2, n3 = D3_GRID
    pde = PDE3D(tmin=0.0, tmax=1.0, nt=D3_CASE_NT, L1=1.0, L2=1.0, L3=0.5,
                nx1=n1, nx2=n2, nx3=n3, x=None, name="box3d",
                n_cond_static=N_STATIC)
    return EncProcDec(pde=pde, num_c=1, num_spatial_dims=3,
                      time_window=D3_TW, encoder="enc_grid.ElementWise",
                      decoder="dec_grid.TimeConvDense",
                      dec_delta_mode="per_step", activation="gelu",
                      hidden_features=D3_HIDDEN,
                      hidden_blocks=D3_CASE_BLOCKS, **spec)


def case_trainer(name, argv, device, seed, keys=None):
    """A model case's trainer (``keys``: the grid's trainer entries)."""
    case = CASES[name]
    cfg = case.get("cfg", family_cfg("ufno"))
    if "d3" in case:
        argv = [*argv, f"--time_window={D3_TW}"]
    return build_trainer(cfg, argv, device, keys, case.get("updates"),
                         case_model(name, seed))


def case_batch(name, tr, seed):
    """A model case's batch on the trainer's device: its split's first, or
    a 3D case's generated one (u_base, u_super, pos, cond, an empty t_cond
    and spatial_cond)."""
    import numpy as np
    import torch

    if "d3" not in CASES[name]:
        return first_batch(tr)
    pde = tr.model.pde
    rng = np.random.default_rng(seed + 17)
    u = (0.5 + rng.random((D3_BATCH, 1, D3_CASE_NT, *D3_GRID))).astype(
        np.float32)
    cond = rng.random((D3_BATCH, N_STATIC)).astype(np.float32)
    pos = np.broadcast_to(pde.x.astype(np.float32)[None],
                          (D3_BATCH, *D3_GRID, 3)).copy()
    empty = np.zeros((D3_BATCH, 0), np.float32)
    return tuple(torch.from_numpy(a).to(tr.device)
                 for a in (u, u, pos, cond, empty, empty))


def case_paths(seed, tmp, fam_paths):
    """{case: its argv, weights and reference paths}: the sp world's for
    a case whose reference is the sp family's (sp_family_paths), the
    others' written by case_reference."""
    paths = {}
    for name, case in CASES.items():
        if case.get("ref") == "sp":
            paths[name] = dict(fam_paths[name])
        else:
            paths[name] = {
                "argv": [*train_argv(tmp, seed, 1, f"case_{name}"),
                         *case.get("over", [])],
                "weights": f"{tmp}/case_{name}_weights.pt",
                "ref": f"{tmp}/case_{name}_ref.pt"}
    return paths


def grid_step(tr, batch, depth, steps0, weights):
    """One train step at ``depth`` from ``weights`` and a fresh optimizer:
    its loss, ms (host clock around the synchronised step), K1 and K2
    launches, collective bytes and peak memory."""
    import torch

    from nps_tpu_torch import kernels
    from nps_tpu_torch.parallel import spatial

    tr.load_model(weights)
    tr.set_optimizer(tr.optimizer_spec)
    kernels.reset_launches()
    spatial.traffic.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, _ = tr.train_step(batch, 0, 0, unrolled=depth, steps0=steps0)
    torch.cuda.synchronize()
    return {"loss": float(loss), "ms": 1e3 * (time.perf_counter() - t0),
            "launches": dict(kernels.launches),
            "collective_bytes": {k: v for k, v in spatial.traffic.items()
                                 if k.endswith("bytes")},
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def held_steps(tr, batch, depths, ref, weights, shapes):
    """A step at each of ``depths`` against ``ref`` (its loss, the
    gradients gathered whole), the kernels' input shapes added to
    ``shapes``; {depth: record}."""
    from nps_tpu_torch import parallel

    steps = {}
    for depth in depths:
        with kernel_shapes() as seen:
            r = grid_step(tr, batch, depth, ref["steps0"][depth], weights)
        for key in shapes:
            shapes[key] |= seen[key]
        r["state_bytes"] = parallel.state_bytes(tr.optimizer)
        r["loss_rel_err"] = abs(r["loss"] - ref["loss"][depth]) / abs(
            ref["loss"][depth])
        r["grad_rel_err"], r["worst_grad"] = _grad_errors(
            tr.whole_grads(), ref["grads"][depth], DP_GRAD_FLOOR)
        steps[str(depth)] = r
    return steps


def case_key(regime, name):
    """The key of case ``name`` under ``regime`` in a rank's records."""
    return f"{regime}_{name}"


def grid_case(regime, name, paths, device, seed, shapes):
    """Model case ``name`` on this rank's world under ``regime`` (a GRID
    key, or "sp": SP_CASE, the batch's rows split over the world): its
    trainer with that regime, from the reference's weights, a step at each
    of its depths (held_steps), the rank's parameter bytes (and under sp
    its rows)."""
    import gc

    import torch

    g = GRID.get(regime, SP_CASE)
    ref = torch.load(paths["ref"], weights_only=False)
    # a 3D batch of D3_BATCH pipelines as that many microbatches
    micro = D3_BATCH if "d3" in CASES[name] else PP_MICRO
    tr = case_trainer(name, paths["argv"], device, seed, {
        "data_parallel": True, g["key"]: g["k"],
        **({"pipeline_microbatches": micro} if regime == "pp" else {})})
    tr.load_model(paths["weights"])
    tr.ensure_initialized()
    batch = case_batch(name, tr, seed)
    if regime == "sp":
        batch = tr.grid.shard_batch(batch)
    seen = {"gn": set(), "spectral": set()}
    rec = {"batch": int(batch[1].shape[0]),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in tr.model.parameters()),
           "steps": held_steps(tr, batch, CASES[name]["depths"], ref,
                               paths["weights"], seen)}
    rec["shapes"] = {k: [list(v) for v in sorted(vs)]
                     for k, vs in seen.items()}
    if regime == "sp":
        rec["rows"] = int(batch[1].shape[3])
    for key in shapes:
        shapes[key] |= seen[key]
    del tr, batch, ref
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def grid_worker(spec_path):
    """One rank of a grid phase (``chip_smoke.py --grid-worker SPEC``): join
    the gloo world on the card, build the trainer with the phase's regime,
    take the first global batch of the split (the whole batch: D = 1), then
    from the reference weights with a fresh optimizer: a warm-up step, one
    step at each of the phase's depths (loss, the gradients gathered whole
    against the reference's, launches, collective bytes, ms, peak memory,
    parameter and optimizer-state bytes, the shapes the kernels saw), under
    tp the evaluation of a cut of the batch, the phase's model cases
    (grid_case), and last one forward apply under torch.profiler (K1's and
    K2's kernels counted by name). Writes its record to the spec's ``out``
    as JSON, with the wall-clock times it started and ended."""
    import torch

    from nps_tpu_torch import kernels, parallel
    from nps_tpu_torch.inference import autotuned_convs

    started = time.time()
    spec = json.loads(Path(spec_path).read_text())
    phase = spec["phase"]
    g = GRID[phase]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = parallel.init_distributed(
        f"tcp://127.0.0.1:{spec['port']}", world_size=g["k"],
        rank=spec["rank"], backend="gloo", device="cuda",
        timeout=GRID_TIMEOUT)
    rank = parallel.world()[0]
    rec = {"rank": rank, "device": str(device),
           "backend": torch.distributed.get_backend(), "cases": {}}
    try:
        with autotuned_convs(deterministic=True):
            tr = build_trainer(family_cfg(g["cfg"]), [
                *spec["argv"], "--trainer.data_parallel=true",
                f"--trainer.{g['key']}={g['k']}", *g["flags"]], device)
            rec["go_waited_s"] = wait_go(spec["go"], GRID_TIMEOUT)
            ref = torch.load(spec["ref"], weights_only=False)
            tr.load_model(spec["weights"])
            tr.ensure_initialized()
            batch = first_batch(tr)
            rec["batch"] = int(batch[1].shape[0])
            rec["param_bytes"] = sum(p.numel() * p.element_size()
                                     for p in tr.model.parameters())
            if phase != "tp":   # warm-up: cuDNN's timing, gloo's rings
                grid_step(tr, batch, g["depths"][0],
                          ref["steps0"][g["depths"][0]], spec["weights"])
            shapes = {"gn": set(), "spectral": set()}
            rec["steps"] = held_steps(tr, batch, g["depths"], ref,
                                      spec["weights"], shapes)
            if phase == "tp":
                tr.load_model(spec["weights"])
                info, pred = eval_rollout(
                    tr, tuple(a[:TP_EVAL_B] for a in batch), TP_EVAL_T)
                if rank == 0:
                    ev = torch.load(spec["eval_ref"], weights_only=False)
                    rec["eval"] = eval_errors(info, pred, ev["info"],
                                              ev["pred"])
            for regime, name in GRID_CASES[phase]:
                t0 = time.perf_counter()
                key = case_key(regime, name)
                rec["cases"][key] = grid_case(regime, name,
                                              spec["cases"][name], device,
                                              spec["seed"], shapes)
                rec["cases"][key].update(
                    regime=regime, case=name,
                    seconds=time.perf_counter() - t0)
            rec["shapes"] = {k: [list(v) for v in sorted(vs)]
                             for k, vs in shapes.items()}
            # last (a profiler session slows the host for the rest of the
            # process): one forward apply's K1 and K2 kernels by name
            tr.load_model(spec["weights"])
            kernels.reset_launches()

            def forward():
                with torch.no_grad():
                    tr._apply(batch[1][:, :, :TW], batch[3], None, batch[2],
                              None, batch[5])

            forward()
            want = {k: v for k, v in kernels.launches.items()
                    if k in ("gn1_gelu_fwd", "spectral_dft2d_fwd")}
            counts, busy, ms, attempts = profiled_counts(forward, want)
            rec["profiled"] = {"what": "one forward apply", "counts": counts,
                               "want": want, "busy_share": busy, "ms": ms,
                               "attempts": attempts}
    finally:
        torch.distributed.destroy_process_group()
    rec["clock"] = [started, time.time()]
    Path(spec["out"]).write_text(json.dumps(rec))
    return 0


def grid_paths(name, seed, tmp, dp_argv):
    """The paths of grid phase ``name``'s one process (grid_reference): its
    argv, weights and reference file (and tp's evaluation reference). tp
    and pp take the dp phase's cfg_twophase_ufno argv and weights."""
    paths = {"argv": dp_argv, "weights": f"{tmp}/dp_weights.pt",
             "ref": f"{tmp}/{name}_ref.pt"}
    if GRID[name]["cfg"] != "ufno":
        paths.update(argv=train_argv(tmp, seed, 1, f"{name}_single"),
                     weights=f"{tmp}/{name}_weights.pt")
    if name == "tp":
        paths["eval_ref"] = f"{tmp}/tp_eval_ref.pt"
    return paths


def grid_reference(name, seed, paths):
    """The one process the phase's ranks are held to, on the card, written
    to ``paths`` (grid_paths); returns its record. tp and pp take the dp
    phase's cfg_twophase_ufno weights, ep draws the full-width
    cfg_twophase_moe from the seed; each steps them at the phase's depths
    (after a warm-up; start steps drawn from the seed: loss, gradients),
    then records a depth-0 step's ms, parameter and optimizer-state bytes
    and peak memory, and tp the evaluation of its cut of the batch."""
    import gc

    import torch

    from nps_tpu_torch import parallel
    from nps_tpu_torch.inference import autotuned_convs

    g = GRID[name]
    argv, weights, ref_path = paths["argv"], paths["weights"], paths["ref"]
    tr = build_trainer(family_cfg(g["cfg"]), argv, "cuda")
    tr.ensure_initialized()
    if g["cfg"] == "ufno":
        tr.load_model(weights)
    else:
        torch.save({k: v.detach().cpu() for k, v in
                    tr.model.state_dict().items()}, weights)
    batch = first_batch(tr)
    rec = {"param_bytes": sum(p.numel() * p.element_size()
                              for p in tr.model.parameters())}
    with autotuned_convs(deterministic=True):
        tr.train_step(batch, 0, 0, unrolled=0)   # warm-up
        ref = reference_steps(tr, batch, g["depths"], weights,
                              torch.Generator().manual_seed(seed + 4))
        torch.save(ref, ref_path)
        steps0 = ref["steps0"][0]
        del ref
        tr.load_model(weights)
        tr.set_optimizer(tr.optimizer_spec)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr.train_step(batch, 0, 0, unrolled=0, steps0=steps0)
        torch.cuda.synchronize()
        rec["depth0_ms"] = 1e3 * (time.perf_counter() - t0)
        rec["state_bytes"] = parallel.state_bytes(tr.optimizer)
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        if name == "tp":
            tr.load_model(weights)
            info, pred = eval_rollout(
                tr, tuple(a[:TP_EVAL_B] for a in batch), TP_EVAL_T)
            torch.save({"info": info, "pred": pred}, paths["eval_ref"])
    del tr, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def case_reference(name, seed, paths):
    """The one process a model case's ranks are held to, on the card: its
    weights drawn from the seed (saved to ``paths``), a warm-up step, then
    a step at each of its depths (reference_steps) and its peak memory."""
    import gc

    import torch

    from nps_tpu_torch.inference import autotuned_convs

    tr = case_trainer(name, paths["argv"], "cuda", seed)
    tr.ensure_initialized()
    torch.save({k: v.detach().cpu() for k, v in
                tr.model.state_dict().items()}, paths["weights"])
    batch = case_batch(name, tr, seed)
    torch.cuda.reset_peak_memory_stats()
    with autotuned_convs(deterministic=True):
        tr.train_step(batch, 0, 0, unrolled=0)   # warm-up
        ref = reference_steps(tr, batch, CASES[name]["depths"],
                              paths["weights"],
                              torch.Generator().manual_seed(seed + 7))
    ref["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.save(ref, paths["ref"])
    del tr, batch
    gc.collect()
    torch.cuda.empty_cache()


def grid_check(name, card, gen, single, logs, outs, rcs, seconds, cases):
    """One grid phase's ranks held to its reference, and each of its model
    cases to its own (``cases``: case_paths); both kernel ops then against
    their plain versions at every shape the ranks' steps gave them, and
    timed at the cases' new shapes (K1 at the tp share of the
    time-conditioned U-FNO and at the ep MoE's input with its BC code, K2
    at the attention U-FNO's largest input under pp). Prints the phase's
    line, the per-rank and per-case lines; returns ({"<phase>" and
    "<regime>_<case>": rank 0's launches at the last depth}, the kernel
    records by kernel and key, the failures)."""
    import torch

    g = GRID[name]
    failures = [f"rank {r} exited {rc}:\n{_tail(log)}"
                for r, (rc, log) in enumerate(zip(rcs, logs)) if rc != 0]
    ranks = ([json.loads(o.read_text()) for o in outs]
             if all(rc == 0 for rc in rcs) else [])

    def held(who, regime, steps, want_fn, batch, want_batch, share,
             whole):
        if batch != want_batch:
            failures.append(f"{who}: batch {batch}, want {want_batch}")
        for depth, s in steps.items():
            want = want_fn(int(depth))
            if not (s["loss_rel_err"] <= DP_LOSS_TOL
                    and s["grad_rel_err"] <= REL_TOL_GRAD
                    and s["launches"] == want):
                failures.append(f"{who} depth {depth}: {s}, launches want "
                                f"{want}")
        if (share < 1) != (regime not in ("pp", "sp")) or share > 1:
            failures.append(f"{who}: parameter share {share} of {whole}")

    case_single = {c: torch.load(cases[c]["ref"], weights_only=False)
                   for _, c in GRID_CASES[name]}
    case_single = {c: {k: ref[k] for k in ("param_bytes", "state_bytes",
                                            "batch", "peak_mem_gib")
                       if k in ref}
                   for c, ref in case_single.items()}
    for r in ranks:
        if r["backend"] != "gloo":
            failures.append(f"rank {r['rank']}: {r['backend']}")
        held(f"rank {r['rank']}", name, r["steps"],
             lambda d: grid_launches(name, d), r["batch"], TRAIN_BATCH,
             r["param_bytes"] / single["param_bytes"], single["param_bytes"])
        for key, rc in r["cases"].items():
            c = rc["case"]
            one = case_single[c]
            held(f"rank {r['rank']} {key}", rc["regime"], rc["steps"],
                 lambda d, c=c: case_launches(c, d), rc["batch"],
                 one["batch"], rc["param_bytes"] / one["param_bytes"],
                 one["param_bytes"])
            # under sp: this rank's share of the rows, and the halos or
            # partial sums crossed the x group in every step
            if rc["regime"] == "sp" and (
                    rc["rows"] != D3_GRID[0] // SP_K or not all(
                        s["collective_bytes"] for s in rc["steps"].values())):
                moved = [s["collective_bytes"] for s in rc["steps"].values()]
                failures.append(f"rank {r['rank']} {key}: rows "
                                f"{rc['rows']}, collectives {moved}")
        p = r["profiled"]
        fwd = {k: v for k, v in grid_launches(name, 0).items()
               if k in ("gn1_gelu_fwd", "spectral_dft2d_fwd")}
        if not p["counts"] == p["want"] == fwd:
            failures.append(f"rank {r['rank']}: profiled {p}, want {fwd}")
    if ranks and [(rc["regime"], rc["case"])
                  for rc in ranks[0]["cases"].values()
                  ] != list(GRID_CASES[name]):
        failures.append(f"cases {sorted(ranks[0]['cases'])}")
    ev = ranks[0].get("eval") if ranks else None
    if name == "tp" and ranks and not (
            ev["step_loss_rel_err"] <= DP_LOSS_TOL
            and ev["window_rel_err"][0] <= DP_EVAL_TOL):
        failures.append(f"evaluation against the single process: {ev}")

    def rows_of(rs, key):
        return {tuple((tuple(x) if isinstance(x, list) else x) for x in row)
                for r in rs for row in r["shapes"][key]}

    seen = {k: rows_of(ranks, k) for k in ("gn", "spectral")}
    shape_rows = check_shapes(seen, gen) if ranks else []
    bad = [row for row in shape_rows if not (
        row["rel_err_y"] < REL_TOL_F32 and row["rel_err_grad"] < REL_TOL_GRAD)]
    if bad:
        failures.append(f"kernel ops at the {name} shapes: {bad}")
    # the cases' new shapes, timed (kernel records)
    kern = {}
    if ranks:
        first = [r["cases"] for r in ranks[:1]]
        if name in ("tp", "ep"):
            case = "ufno_tcond" if name == "tp" else "moe_bc"
            shape, co, _ = max(rows_of([c[case_key(name, case)]
                                        for c in first], "spectral"))
            kern["spectral_dft2d_fwd"] = {
                f"{name}_{case}_shape": spectral_fwd_record(gen, shape, co)}
        else:
            shape, _ = max(rows_of([c[case_key("pp", "ufno_attn")]
                                    for c in first], "gn"),
                           key=lambda row: math.prod(row[0]))
            kern["gn1_gelu_fwd"] = {"pp_ufno_attn_shape":
                                    gn_fwd_record(gen, shape)}
    emit({"phase": name, "config": family_cfg(g["cfg"]), "k": g["k"],
          "data_slices": 1, "backend": "gloo", "global_batch": TRAIN_BATCH,
          "depths": list(g["depths"]), "flags": g["flags"],
          "timing": f"{g['k']} ranks sharing one card with the other grid "
                    "phases' ranks: host clock around one synchronised step "
                    "each, cuDNN's deterministic algorithms; says nothing "
                    "about scaling",
          "single_process": single, "cases_single_process": case_single,
          "seconds": seconds, "ranks": ranks,
          "launches_per_rank_expected": {
              str(d): grid_launches(name, d) for d in g["depths"]},
          "kernel_shapes": shape_rows, "card": card, "tf32": False})
    last = str(g["depths"][-1])
    for r in ranks:
        s = r["steps"][last]
        print(f"{name} rank {r['rank']} ({g['k']} ranks sharing one card "
              f"with the other grid phases'): "
              f"step ms " + ", ".join(
                  f"depth {d} {r['steps'][str(d)]['ms']:.1f}"
                  for d in g["depths"])
              + f"; parameter bytes {r['param_bytes']} of one process's "
              f"{single['param_bytes']}, optimizer-state bytes "
              f"{s['state_bytes']} of {single['state_bytes']}; peak GiB "
              f"{s['peak_mem_gib']:.2f} (one process at depth 0 "
              f"{single['peak_mem_gib']:.2f}); launches per rank at depth "
              f"{last} {s['launches']}, profiled in a forward apply "
              f"{r['profiled']['counts']}; "
              f"collective bytes {s['collective_bytes']}", flush=True)
        for rc in r["cases"].values():
            c = rc["case"]
            one = case_single[c]
            cl = str(CASES[c]["depths"][-1])
            sc = rc["steps"][cl]
            rows = f", rows {rc['rows']}" if "rows" in rc else ""
            print(f"{name} rank {r['rank']} case {c} under "
                  f"{rc['regime']} (batch {rc['batch']}{rows}, "
                  f"{rc['seconds']:.1f} s): loss rel err " + ", ".join(
                      f"depth {d} {v['loss_rel_err']:.3g}"
                      for d, v in rc["steps"].items())
                  + "; gradients " + ", ".join(
                      f"depth {d} {v['grad_rel_err']:.3g}"
                      for d, v in rc["steps"].items())
                  + f"; step ms " + ", ".join(
                      f"depth {d} {v['ms']:.1f}"
                      for d, v in rc["steps"].items())
                  + f"; parameter bytes {rc['param_bytes']} of one "
                  f"process's {one['param_bytes']}, optimizer-state bytes "
                  f"{sc['state_bytes']} of {one['state_bytes']}; peak GiB "
                  f"{sc['peak_mem_gib']:.2f}; launches at depth {cl} "
                  f"{sc['launches']}", flush=True)
    launches = {}
    if ranks:
        launches[name] = ranks[0]["steps"][last]["launches"]
        for key, rc in ranks[0]["cases"].items():
            launches[key] = rc["steps"][str(
                CASES[rc["case"]]["depths"][-1])]["launches"]
    return launches, kern, failures


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/chip_smoke")
    ap.add_argument("--dp-worker", help=argparse.SUPPRESS)
    ap.add_argument("--sp-worker", help=argparse.SUPPRESS)
    ap.add_argument("--grid-worker", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    import nps_tpu_torch  # noqa: F401  (fails outside a checkout)

    if args.dp_worker:
        return dp_worker(args.dp_worker)
    if args.sp_worker:
        return sp_worker(args.sp_worker)
    if args.grid_worker:
        return grid_worker(args.grid_worker)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lines.jsonl", "w") as lines:
        LINES["file"] = lines
        try:
            return run_phases(args, out_dir)
        finally:
            LINES["file"] = None


def run_phases(args, out_dir):
    """Every phase in turn (the module note), then the seconds, kernels,
    card and device lines."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    started, seconds = time.perf_counter(), {}

    def clocked(name, fn, *a):
        t0 = time.perf_counter()
        try:
            return fn(*a)
        finally:
            seconds[name] = time.perf_counter() - t0

    card = clocked("device", phase_device)
    clocked("build", phase_build, out_dir)
    kern = clocked("kernels", phase_kernels, gen)
    serve = clocked("slice", phase_slice, args.seed, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        gen_s = clocked("split", make_split, tmp, args.seed)
        train = clocked("train", phase_train, args.seed, card, out_dir, tmp,
                        gen_s)
        dp, dp_argv = clocked("dp", phase_dp, args.seed, card, out_dir, tmp)
        clocked("pushforward_fast", phase_pushforward_fast, args.seed, card,
                gen, tmp)
        families = clocked("families", phase_families, args.seed, card,
                           out_dir, tmp)
        p13a, p13a_kern = clocked("p13a", phase_p13a, args.seed, card, gen,
                                  out_dir, tmp)
        families.update(p13a)
        for name, rec in p13a_kern.items():
            kern[name]["tcond_shape"] = {
                k: v for k, v in gn_bwd_measured(rec).items()
                if k not in ("phase", "name")}
        clocked("gnn_bf16", gnn_bf16, args.seed, card, tmp)
        ns512, ns_kern, gn_inputs = clocked("ns512", phase_ns512, args.seed,
                                            card, gen, tmp)
        kern.update(ns_kern)
        ns512_train, ns512_accum, ns_train_kern = clocked(
            "ns512_train", phase_ns512_train, args.seed, card, gen, out_dir,
            tmp, gn_inputs)
        kern.update(ns_train_kern)
        # the sp and grid worlds share one batch of ranks: its references
        # and its ranks' seconds under "sp_grids_references" and
        # "sp_grids_ranks"
        sp, sp_kern, grid, case_kern, parts = clocked(
            "sp_grids", phase_worlds, args.seed, card, gen, out_dir, tmp,
            dp_argv)
        seconds.update({f"sp_grids_{k}": v for k, v in parts.items()})
        for name, recs in case_kern.items():
            kern[name].update({k: {f: v for f, v in r.items()
                                   if f not in ("phase", "name")}
                               for k, r in recs.items()})
        var1d = clocked("var1d", phase_var1d, args.seed, card, out_dir, tmp)
        kern["spectral_dw2d"]["ns512"] = kern.pop("spectral_dw2d_ns512")
        # after training: torch.export keeps the constants it traced (the
        # spectral packs) alive for the rest of the process
        export, artifact = clocked("export", phase_export, args.seed, card,
                                   tmp)
        replays = clocked("profile", phase_profile, args.seed, card,
                          artifact)
    for name, by_dtype in clocked("stages", phase_stages, gen).items():
        kern[name]["stages"] = by_dtype["torch.bfloat16"]
        kern[name]["f32"]["stages"] = by_dtype["torch.float32"]
    emit({"phase": "seconds", **seconds,
          "total": time.perf_counter() - started})

    # name -> (source, TPU kernel replaced, the path whose run gives
    # "launches"[, the counter it reads when not its own name]); the forward
    # kernels keep the serving path's count
    sources = {
        "gn1_gelu_fwd": ("nps_tpu_torch/csrc/gn1_gelu.cu",
                         "tools/pallas_group_norm_evidence.py:61", serve),
        "gn1_gelu_bwd": ("nps_tpu_torch/csrc/gn1_gelu.cu (gn1_bwd_ticket, "
                         "one launch after a memset of its counters: "
                         "gn1_gelu_bwd's route for samples of x and dy of "
                         "BWD_THREE_BELOW bytes or more)",
                         "tools/pallas_group_norm_evidence.py:106 (_gn_bwd, "
                         "XLA)", train, "gn1_gelu_bwd_ticket"),
        "gn1_gelu_bwd_three": (
            "nps_tpu_torch/csrc/gn1_gelu.cu (gn1_bwd_sums, gn1_bwd_reduce, "
            "gn1_bwd_apply: gn1_gelu_bwd's route for samples under "
            "BWD_THREE_BELOW bytes; at the U-Net's [16, 256, 9, 5], "
            "launches on the U-Net's training run)",
            "tools/pallas_group_norm_evidence.py:106 (_gn_bwd, XLA)",
            families["unet_train"], "gn1_gelu_bwd_three"),
        "spectral_dft2d_fwd": (
            "nps_tpu_torch/csrc/spectral_dft2d.cu",
            "nps_tpu/ops/pallas/spectral_dft.py:144 (git 92d7866^)", serve),
        "spectral_dft2d_bwd": (
            "nps_tpu_torch/csrc/spectral_dft2d.cu (spectral_dft2d_bwd on dy "
            "with the forward's pack + spectral_dw2d; ms, plain_ms, "
            "library_ms of the whole backward)",
            "nps_tpu/ops/pallas/spectral_dft.py:175 (git 92d7866^, "
            "_pallas_bwd, XLA)", train),
        "spectral_dw2d": (
            "nps_tpu_torch/csrc/spectral_dft2d.cu",
            "nps_tpu/ops/pallas/spectral_dft.py:175 (git 92d7866^, "
            "_pallas_bwd, XLA: its weight gradient)", train),
        "spectral_dft2d_fwd_large": (
            "nps_tpu_torch/csrc/spectral_dft2d.cu (large-plane variant: "
            "dft_fwd_tc_kernel, sum_tiles_kernel, mix_kernel, "
            "dft_inv_tc_kernel in bf16, the FMA stages dft_fwd_big_kernel "
            "and dft_inv_big_kernel in f32; at the ns512 call in bf16, its "
            "f32 record under f32; per-stage device times under stages)",
            "nps_tpu/ops/pallas/spectral_dft.py:144 (git 92d7866^)", ns512),
        "gn1_gelu_fwd_stream": (
            "nps_tpu_torch/csrc/gn1_gelu.cu (streaming variant: "
            "gn1_stream_sums, gn1_stream_stats, gn1_stream_apply; at the "
            "largest ns512 GroupNorm input in bf16, every shape under "
            "shapes)",
            "tools/pallas_group_norm_evidence.py:61", ns512),
        "spectral_dft2d_bwd_large": (
            "nps_tpu_torch/csrc/spectral_dft2d.cu (large-plane input "
            "gradient: dft_fwd_tc_kernel and sum_tiles_kernel on dy, "
            "film_bwd_kernel with FiLM, mix_adj_kernel, dft_inv_tc_kernel "
            "in bf16, the FMA stages in f32; at the ns512 call in bf16, its "
            "f32 record under f32; per-stage device times under stages)",
            "nps_tpu/ops/pallas/spectral_dft.py:175 (git 92d7866^, "
            "_pallas_bwd, XLA)", ns512_train),
        "gn1_gelu_bwd_bf16": (
            "nps_tpu_torch/csrc/gn1_gelu.cu (gn1_bwd_ticket on bf16 x and "
            "dy; at the largest ns512 GroupNorm "
            "input with the tanh GELU "
            "as ns512 runs it; both shapes with the GELU off and tanh under "
            "shapes; the 66 calls of one ns512 train step under "
            "step_calls)",
            "tools/pallas_group_norm_evidence.py:106 (_gn_bwd, XLA)",
            ns512_train, "gn1_gelu_bwd_ticket")}
    line = []
    route_paths = {"train": train, "ns512_train": ns512_train,
                   **{p: n for p, n in families.items()
                      if p.endswith("_train")}}
    eager = {"gn1_gelu_bwd": "plain and library", "spectral_dft2d_bwd":
             "plain and library", "gn1_gelu_bwd_bf16": "plain and library",
             "gn1_gelu_bwd_three": "plain and library",
             "spectral_dft2d_bwd_large": "library"}

    def by_path(key):
        return {"serve": serve.get(key, 0),
                "captured": replays["ufno"].get(key, 0),
                "export": export.get(key, 0),
                "train": train.get(key, 0),
                "ns512": ns512.get(key, 0),
                "ns512_train": ns512_train.get(key, 0),
                "ns512_train_grad_accum": ns512_accum.get(key, 0),
                "var1d": var1d.get(key, 0),
                "dp_rank": dp.get(key, 0),
                "sp_rank": sp.get(key, 0),
                **{f"{g}_rank": n.get(key, 0) for g, n in grid.items()},
                **{p: n.get(key, 0) for p, n in families.items()},
                **{f"{f}_captured": n.get(key, 0)
                   for f, n in replays.items() if f != "ufno"},
                "gnn": sum(n.get(key, 0) for p, n in families.items()
                           if p.startswith("gnn_"))}

    for name, (src, replaces, path, *counter) in sources.items():
        r = kern[name]
        count = counter[0] if counter else name
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": path.get(count, 0),
                     "launches_by_path": by_path(count),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"],
                     "bound_share": r["bound_share"], "parity": "ok",
                     "timing": "device: CUDA graph of "
                               + ("5" if any(path is p for p in
                                             (ns512, ns512_train))
                                  else "20")
                               + " calls, replayed"
                               + (f"; {eager[name]}: eager calls between "
                                  "CUDA events" if name in eager else "")})
        for key in ("timing_refused", "same_bits", "film", "unet_shapes",
                    "dispatch_host_us", "library_how", "dtype", "shape",
                    "act", "bound_f32_ops_ms", "f32", "shapes", "ns512", "stages",
                    "step_calls", "tp_shape", "tcond_shape",
                    "tp_ufno_tcond_shape", "ep_moe_bc_shape",
                    "pp_ufno_attn_shape"):
            if key in r:
                line[-1][key] = r[key]
        if "adjoint" in r:   # the backward's adjoint launch alone
            line[-1]["adjoint"] = {k: r["adjoint"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "bound_share")}
        if count.startswith("gn1_gelu_bwd_"):
            # the backward's routes are counted on the training runs only
            # (with_routes), the wrapper's calls on every path; each route's
            # launches a call by kernel name in the profile phase
            # (gn_bwd_by_name)
            line[-1]["calls_by_path"] = by_path("gn1_gelu_bwd")
            line[-1]["launches_by_path"] = {
                p: n.get(count, 0) for p, n in route_paths.items()}
            line[-1]["launches_per_call"] = GN_BWD_BY_NAME[
                "launches_per_call"].get(count[len("gn1_gelu_bwd_"):])
    for name, r in sp_kern.items():
        line.append({"name": name, "route": "cuda",
                     "source": "nps_tpu_torch/csrc/"
                               + ("spectral_dft2d.cu" if name.startswith(
                                   "spectral") else "gn1_gelu.cu")
                               + " (a stage of the row split, spatial "
                                 "parallelism; its twophase local shape, "
                                 "the ns512 and time-conditioned ones under "
                                 "ns512 and tcond)",
                     "replaces": SP_ENTRIES[name],
                     "launches": sp.get(name, 0),
                     "launches_by_path": r.pop("launches_by_path"),
                     **{k: r[k] for k in (
                         "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms", "bound_share")},
                     "parity": "ok",
                     "timing": "device: CUDA graph of 20 calls (5 for the "
                               "GroupNorm stages), replayed",
                     **{k: r[k] for k in ("shape", "ns512", "tcond",
                                          "adjoint", "plain",
                                          "timing_refused")
                        if k in r}})
    with open(out_dir / "kernels.json", "w") as f:
        json.dump({"card": card, "kernels": line}, f, indent=1)
    idle = [k["name"] for k in line if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels launched no time on their path: "
                             f"{idle}")
    emit({"kernels": line})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
