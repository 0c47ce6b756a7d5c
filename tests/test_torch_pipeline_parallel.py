"""Pipeline parallelism in the port (``nps_tpu_torch.parallel.pipeline``):
the U-FNO's blocks streamed over a pipe axis (GPipe), in real gloo worlds
on the CPU of K = 2 (two processes, one block a stage) and of 2 data
slices x K = 2 (four), held against the port's single-process forward,
train step and evaluation and against ``nps_tpu``'s forward and
``jax.grad``, with the harness, sizes and bars of
``torch_grid_harness.py``. The cases mirror
``tests/test_pipeline_parallel.py``: the U-FNO's forward and gradients,
the microbatch knob, DRN blocks, a processor list with the residual, MoE
blocks, heterogeneous chains refused, never-dividing microbatches refused,
the train step against one process, the trainer end to end; besides, a
batch the microbatches do not tile runs the sequential chain (forward and
gradients), each parameter tag's gradient is reduced once, and the MP-GNN
is refused. The BC-encoder case of the JAX tests is
``tests/test_torch_conditioning.py::test_pipelined_bc_encoder_path``. The
worlds also run the model cases (the harness's ``CASES``): the U-FNO with
attention in its mini U-Nets and the 3D FNO and DRN block by block, and a
list of two attention U-Nets one a stage, each against one process and
JAX.
"""

import os
import sys
from argparse import Namespace

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_grid_harness as H  # noqa: E402
from test_torch_distributed import TW, _tensors  # noqa: E402

JAX_CFG = "nps_tpu/configs/train/cfg_twophase_ufno.py"
PORT_CFG = "nps_tpu_torch/configs/train/cfg_twophase_ufno.py"
FLAGS = ["--trainer.data_parallel=true",
         f"--trainer.pipeline_parallel={H.K}"]
MICRO = ["--trainer.pipeline_microbatches=2"]
REMAINDER = 3   # a batch of 3 that microbatches of 2 do not tile


def sc_micro(spec, g):
    """The forward and the step with two microbatches a local batch."""
    tr = H.grid_trainer(spec, extra=MICRO)
    batch, steps0 = H.mine(tr, g["batch"], g["steps0"])
    with torch.no_grad():
        fwd = tr.grid.gather_frames(H.first_window(tr, batch))
    loss, _ = tr.train_step(batch, 0, 0, unrolled=1, steps0=steps0)
    return dict(forward=fwd, loss=float(loss), grads=tr.whole_grads())


def sc_remainder(spec, g):
    """A local batch of 3 under two microbatches: the sequential chain on
    every pipe rank (one data slice)."""
    tr = H.grid_trainer(spec, extra=MICRO)
    batch = tuple(t[:REMAINDER] for t in _tensors(g["batch"]))
    with torch.no_grad():
        fwd = H.first_window(tr, batch)
    loss, _ = tr.train_step(batch, 0, 0, unrolled=1,
                            steps0=g["steps0"][:REMAINDER])
    return dict(forward=fwd, loss=float(loss), grads=tr.whole_grads())


def _processor_list_model(pde):
    from nps_tpu_torch.models.activations import GELU
    from nps_tpu_torch.models.enc_proc_dec import EncProcDec

    return EncProcDec(
        pde=pde, encoder="enc_grid.ElementWise",
        processor=[dict(object="FNO"), dict(object="FNO")],
        processor_residual=True, decoder="dec_grid.TimeConvDense",
        num_c=1, num_spatial_dims=2, time_window=TW, activation=GELU(),
        hidden_features=16, fno_modes=4, hidden_blocks=1, fno_kernel_size=1,
        fno_conv_mode="single", padding_mode="circular")


def sc_families(spec, g):
    """The DRN's blocks, a processor list [FNO, FNO] with the residual, and
    the MoE's blocks, pipelined over the pipe axis against their
    sequential forward in this process: max|d| / max|ref|."""
    from nps_tpu_torch import parallel
    from nps_tpu_torch.models.initializers import reset_parameters
    from nps_tpu_torch.parallel import pipeline
    from test_torch_spatial import FAMILIES, _engine, _rollout_inputs

    grid = parallel.Grid(H.K, "pipe")
    moe = ("cfg_twophase_moe.py", H.NX, ["--model.hidden_features=16",
                                         "--model.hidden_blocks=2",
                                         "--model.fno_modes=4"])
    engines = {"drn": _engine(*FAMILIES["drn"]), "moe": _engine(*moe)}
    pde = engines["drn"].pde
    models = {name: e.model for name, e in engines.items()}
    models["processor_list"] = _processor_list_model(pde)
    reset_parameters(models["processor_list"],
                     torch.Generator().manual_seed(0))
    u0, cond, sc = (torch.from_numpy(a) for a in _rollout_inputs(H.NX, 4))
    pos = engines["drn"]._pos(4)
    errs = {}
    for name, model in models.items():
        with torch.no_grad():
            ref = model(u0, cond=cond, pos=pos, spatial_cond=sc)
            with parallel.scope(grid.axis):
                got = model(u0, cond=cond, pos=pos, spatial_cond=sc)
        errs[name] = float((got - ref).abs().max() / ref.abs().max())
    return errs


SCENARIOS = dict(H.COMMON, micro=sc_micro, remainder=sc_remainder,
                 families=sc_families)
# the models beside the U-FNO (torch_grid_harness.CASES): the U-FNO with
# attention in its mini U-Nets (block mode), a list of two attention
# U-Nets (processor mode), the 3D FNO and DRN (block mode)
CASES = ["ufno_attn", "unet_attn_list", "fno3d", "drn3d"]
CASE_N = [(name, n) for name in CASES for n in (2, 4)]


# ------------------------------------------------------------ fixtures
@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    H.generate_split(root)
    return root


@pytest.fixture(scope="module")
def jax_ref(data_dir):
    return H.jax_reference(data_dir, JAX_CFG)


@pytest.fixture(scope="module")
def single(data_dir, jax_ref):
    """The single process's runs, and its forward and step on the first 3
    elements of the batch (the remainder's reference)."""
    ref = H.single_process(data_dir, PORT_CFG, jax_ref)
    with H.one_thread():
        pt = H.trainer(PORT_CFG, data_dir / "data", data_dir / "ref")
        pt.load_model(str(ref["weights"]))
        pt.ensure_initialized()
        batch = tuple(t[:REMAINDER] for t in _tensors(jax_ref["batch"]))
        with torch.no_grad():
            fwd = H.first_window(pt, batch)
        loss, _ = pt.train_step(batch, 0, 0, unrolled=1,
                                steps0=jax_ref["steps0"][:REMAINDER])
        ref["remainder"] = dict(forward=fwd, loss=float(loss),
                                grads=pt.whole_grads())
    return ref


@pytest.fixture(scope="module")
def worlds(data_dir, single):
    return H.case_runs(__file__, data_dir, single, PORT_CFG, FLAGS,
                       {2: list(SCENARIOS),
                        4: ["forward", "step", "eval", "micro"]}, CASES)


def _model(cfg, extra=("--model.fno_modes=4",)):
    from test_torch_spatial import _engine

    return _engine(cfg, H.NX, ["--model.hidden_features=16",
                               *extra]).model


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("n", [2, 4])
def test_pipelined_ufno_forward_matches_sequential(worlds, single, jax_ref,
                                                   n):
    """The wrapped U-FNO (2 blocks) pipelined over 2 stages equals the
    sequential apply, the physics wrapper included, and nps_tpu's."""
    H.check_forward(worlds[n], single, jax_ref)


@pytest.mark.parametrize("n", [2, 4])
def test_pipelined_grads_match_sequential(worlds, single, n):
    """A depth-1 step (its pushforward pipelined too): the loss and every
    gradient equal the single process's, on every rank."""
    H.check_step(worlds[n], single)


@pytest.mark.parametrize("n", [2, 4])
def test_pp_train_step_matches_jax(worlds, jax_ref, n):
    H.check_step_jax(worlds[n], jax_ref)


@pytest.mark.parametrize("n", [2, 4])
def test_pipeline_microbatch_knob(worlds, single, n):
    """pipeline_microbatches=2 (microbatches of 2 at K = 2 alone, of 1 at
    D = 2 x K = 2) still equals the sequential forward and step."""
    for res in worlds[n]["ranks"]:
        got = res["micro"]
        assert H._rel(got["forward"], single["forward"]) <= H.REL_FWD
        np.testing.assert_allclose(got["loss"], single["loss"],
                                   rtol=H.REL_LOSS)
        H._assert_grads_close(got["grads"], single["grads"], H.REL_GRAD,
                              1e-3)


@pytest.mark.parametrize("n", [2, 4])
def test_pp_evaluation_matches_single_process(worlds, single, n):
    H.check_eval(worlds[n], single)


def test_remainder_batch_runs_sequential_apply(worlds, single):
    """A batch of 3 under two microbatches runs the sequential chain on
    every pipe rank: its forward, loss and gradients (the chain's on pipe
    rank 0 alone, summed over the pipe group) are the single process's."""
    ref = single["remainder"]
    for res in worlds[2]["ranks"]:
        got = res["remainder"]
        assert H._rel(got["forward"], ref["forward"]) <= H.REL_FWD
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=H.REL_LOSS)
        H._assert_grads_close(got["grads"], ref["grads"], H.REL_GRAD, 1e-3)


def test_gradient_tags(worlds, single):
    """A stage's weight (its owner's, pipe rank 1), an encoder weight (pipe
    rank 0's, which feeds the pipe) and a decoder weight (whole on every
    rank): each reduced once, neither K times nor 0."""
    H.check_tags(worlds[2], single, {
        "stage": "processor.0.fno_layers.1.conv.weights1",
        "encoder": "encoder.encoder.0.weight",
        "decoder": "decoder.pre_decoder.weight"})


@pytest.mark.parametrize("family", ["drn", "processor_list", "moe"])
def test_pipelined_families(worlds, family):
    """DilatedResnet blocks (the residual inside each block), a
    homogeneous processor list [FNO, FNO] with processor_residual, and
    MoEFNO blocks (each stage's experts and gate together) pipelined equal
    their sequential forward."""
    for res in worlds[2]["ranks"]:
        assert res["families"][family] <= H.REL_FWD


def test_trainer_pipeline_parallel_end_to_end(worlds):
    """train() for an epoch with its evaluation under pipeline_parallel=2:
    finite losses, the same on both ranks; a resume from its checkpoint
    starts at epoch 1 with the trained parameters and optimizer state, bit
    for bit."""
    a, b = (r["epoch"] for r in worlds[2]["ranks"])
    assert np.isfinite(a["train"]).all()
    assert a["train"] == b["train"] and a["val"] == b["val"]
    assert a["resumed_at"] == b["resumed_at"] == 1
    assert a["resumed_same"] and b["resumed_same"]


def test_saved_checkpoint_is_whole(worlds, single):
    H.check_saved(worlds[2], single)


def test_pipeline_rejects_heterogeneous_chain():
    """An FNO -> U-FNO processor list cannot pipeline; a pipe size that does
    not divide the stage count is refused."""
    from nps_tpu_torch.parallel import pipeline

    with pytest.raises(ValueError, match="identical"):
        pipeline.check(_model("cfg_twophase_ufno_fno.py"), 2)
    with pytest.raises(ValueError, match="must divide the stage count"):
        pipeline.check(_model("cfg_twophase_ufno.py", [
            "--model.fno_modes=4", "--model.hidden_blocks=3"]), 2)
    pipeline.check(_model("cfg_twophase_ufno.py", [
        "--model.fno_modes=4", "--model.hidden_blocks=3"]), 3)


def test_pipeline_rejects_never_dividing_microbatches(data_dir,
                                                      monkeypatch):
    """pipeline_microbatches that never divide the steady-state local batch
    (batch 4 over 2 data slices: 2 a slice; 3 microbatches) fail at the
    trainer's setup: every batch would take the sequential path."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    with pytest.raises(ValueError, match="microbatches"):
        H.trainer(PORT_CFG, data_dir / "data", data_dir / "never",
                  [*FLAGS, "--trainer.pipeline_microbatches=3"])


def test_refusals():
    """The MP-GNN under pipeline parallelism, pipeline with tensor
    parallelism, and pipeline parallelism without a process group raise."""
    from nps_tpu_torch.parallel import pipeline
    from nps_tpu_torch.train.base import refuse_unported

    with pytest.raises(ValueError, match="grid models"):
        pipeline.check(_model("cfg_twophase_gnn.py",
                              ["--model.hidden_blocks=2"]), 2)
    with pytest.raises(RuntimeError, match="P9b item 5"):
        refuse_unported(Namespace(data_parallel=True, pipeline_parallel=2))
    with pytest.raises(NotImplementedError, match="P9b item 5"):
        refuse_unported(Namespace(data_parallel=True, pipeline_parallel=2,
                                  tensor_parallel=2))


# ------------------------------------------------------ the model cases
@pytest.mark.parametrize("name,n", CASE_N)
def test_case_forward_matches_single_process_and_jax(worlds, name, n):
    """Each model case pipelined over 2 stages (one a pipe rank) equals the
    port's single process and nps_tpu's."""
    H.check_case_forward(worlds[n], name, worlds["single"][name],
                         worlds["jax"][name])


@pytest.mark.parametrize("name,n", CASE_N)
def test_case_step_matches_single_process(worlds, name, n):
    """Each model case's depth-1 step: the loss and every gradient, on every
    pipe rank (the stages', the encoder's and the attention blocks' summed
    over the pipe group)."""
    H.check_case_step(worlds[n], name, worlds["single"][name])


@pytest.mark.parametrize("name,n", CASE_N)
def test_case_step_matches_jax(worlds, name, n):
    H.check_case_step_jax(worlds[n], name, worlds["jax"][name])


@pytest.mark.parametrize("name,mode", [
    ("ufno_attn", "block"), ("unet_attn_list", "processor"),
    ("fno3d", "block"), ("drn3d", "block")])
def test_case_stages(data_dir, name, mode):
    """How each case splits: the attention U-FNO block by block, with its
    attention blocks inside each stage's ``unet_layers.{i}`` (JAX's
    ``unet_layers_{i}`` key template), the attention U-Nets one processor
    a stage, the 3D FNO and DRN block by block; each over 2 stages."""
    from nps_tpu_torch.models.unet_modern import AttentionBlock
    from nps_tpu_torch.parallel import pipeline

    tr = H.case_trainer(name, data_dir / "data", data_dir / f"{name}_st")
    model = tr.model
    split = pipeline.StageSplit(model)
    assert (split.mode, split.n_stages) == (mode, 2)
    pipeline.check(model, H.K)
    attn = [p for p, m in model.named_modules()
            if isinstance(m, AttentionBlock)]
    if name == "ufno_attn":
        assert {p.split(".")[2] for p in attn} == {"unet_layers"}
        assert {p.split(".")[3] for p in attn} == {"0", "1"}
    elif name == "unet_attn_list":
        assert {p.split(".")[1] for p in attn} == {"0", "1"}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        H.worker(sys.argv[2], SCENARIOS)
