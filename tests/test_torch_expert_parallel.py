"""Expert parallelism in the port (``nps_tpu_torch.parallel.expert``): the
experts of ``cfg_twophase_moe`` (2 blocks x 4 experts x 16 features here)
split over an expert axis, in real gloo worlds on the CPU of K = 2 (two
processes) and of 2 data slices x K = 2 (four), held against the port's
single-process forward, train step and evaluation and against
``nps_tpu``'s forward and ``jax.grad``, with the harness, sizes and bars
of ``torch_grid_harness.py``. The cases mirror
``tests/test_expert_parallel.py``: one expert is the FNO layer, the
partition (experts on their ranks, the rest replicated), a non-divisible
expert stack refused, the sharded step against the unsharded one, the
trainer end to end; besides, the gather of the experts is the whole state
bit for bit, and each parameter tag's gradient is reduced once. The
worlds also run the model cases (the harness's ``CASES``): the MoE with a
BC encoder (its gradient summed over the expert group, on every rank)
and a 3D MoE, each against one process and JAX.
"""

import os
import sys
from argparse import Namespace

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_grid_harness as H  # noqa: E402

JAX_CFG = "nps_tpu/configs/train/cfg_twophase_moe.py"
PORT_CFG = "nps_tpu_torch/configs/train/cfg_twophase_moe.py"
FLAGS = ["--trainer.data_parallel=true", f"--trainer.expert_parallel={H.K}"]
# the split without its static conditioning: the gate pools the hidden state
NO_COND = ["--dataset.conditioning=None"]


def sc_held(spec, g):
    """The parameter elements this rank holds, and which experts."""
    tr = H.grid_trainer(spec)
    return dict(numel=sum(p.numel() for p in tr.model.parameters()),
                experts=sorted({int(k.split(".")[4]) for k, p in
                                tr.model.named_parameters()
                                if ".experts." in k and p.numel()}))


SCENARIOS = dict(H.COMMON, held=sc_held)
# the models beside the MoE (torch_grid_harness.CASES): the MoE with a BC
# encoder over t_cond, and a 3D MoE
CASES = ["moe_bc", "moe3d"]
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
    root = tmp_path_factory.mktemp("expert")
    H.generate_split(root)
    return root


@pytest.fixture(scope="module")
def jax_ref(data_dir):
    return H.jax_reference(data_dir, JAX_CFG)


@pytest.fixture(scope="module")
def single(data_dir, jax_ref):
    return H.single_process(data_dir, PORT_CFG, jax_ref)


@pytest.fixture(scope="module")
def worlds(data_dir, single):
    return H.case_runs(__file__, data_dir, single, PORT_CFG, FLAGS,
                       {2: list(SCENARIOS), 4: ["forward", "step", "eval"]},
                       CASES)


@pytest.fixture(scope="module")
def pooled_gate(tmp_path_factory):
    """The world of 2 ranks, the single process and JAX on the split
    without static conditioning (a split of its own: the harness writes
    the weights and inputs beside the data)."""
    root = tmp_path_factory.mktemp("expert_no_cond")
    H.generate_split(root)
    jax_ref = H.jax_reference(root, JAX_CFG, NO_COND)
    single = H.single_process(root, PORT_CFG, jax_ref, NO_COND)
    world = H.run_world(__file__, root, single, 2, PORT_CFG,
                        [*FLAGS, *NO_COND], ["step"])
    return world, single, jax_ref


def _moe_model(n_experts=4):
    from test_torch_spatial import _engine

    return _engine("cfg_twophase_moe.py", H.NX, [
        "--model.hidden_features=16", "--model.hidden_blocks=2",
        "--model.fno_modes=4", f"--model.n_experts={n_experts}"]).model


# ------------------------------------------------------------------ tests
def test_moe_e1_equals_plain_fno_layer():
    """One expert: the gate is 1 and a block is exactly its FNO layer with
    the activation, bit for bit (the block ``pipeline_parallel`` and the
    expert split call)."""
    model = _moe_model(1)
    moe = model.processor[0]
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((2, 16, 16, 16),
                                             dtype=np.float32))
    vb = torch.from_numpy(rng.standard_normal((2, 4, 16, 16),
                                              dtype=np.float32))
    cond = torch.from_numpy(rng.standard_normal((2, 2), dtype=np.float32))
    with torch.no_grad():
        got = moe.block(0, h, cond, vb)
        want = moe.act(moe.experts[0][0](torch.cat([h, vb], dim=1)))
    assert torch.equal(got, want)


def test_expert_partition_specs():
    """Expert e of every block on rank e // (E / K); the gates, the encoder
    and the decoder replicated."""
    from nps_tpu_torch.parallel import expert

    specs = expert.partition_specs(_moe_model(), H.K)
    experts = {k: v for k, v in specs.items() if ".experts." in k}
    assert experts and all(v == int(k.split(".")[4]) // 2
                           for k, v in experts.items())
    rest = {k: v for k, v in specs.items() if ".experts." not in k}
    assert any(".gate." in k for k in rest)
    assert all(v is None for v in rest.values())


def test_expert_specs_reject_non_divisible_stack():
    """An expert count K does not divide raises (the experts would run K
    times over while they look split)."""
    from nps_tpu_torch.parallel import expert

    with pytest.raises(ValueError, match="n_experts"):
        expert.partition_specs(_moe_model(3), H.K)
    with pytest.raises(ValueError, match="MoEFNO"):
        from test_torch_spatial import FAMILIES, _engine

        expert.check(_engine(*FAMILIES["ufno"]).model, H.K)


def test_each_rank_holds_its_experts(worlds, single):
    """Rank r holds experts [2r, 2r + 2) of every block and nothing of the
    others: its parameter elements are the whole model's less half the
    experts'."""
    want = torch.load(single["weights"], weights_only=True)
    total = sum(v.numel() for v in want.values())
    experts = sum(v.numel() for k, v in want.items() if ".experts." in k)
    for r, res in enumerate(worlds[2]["ranks"]):
        assert res["held"]["experts"] == [2 * r, 2 * r + 1]
        assert res["held"]["numel"] == total - experts // 2


@pytest.mark.parametrize("n", [2, 4])
def test_expert_sharded_forward_matches_unsharded(worlds, single, jax_ref,
                                                  n):
    H.check_forward(worlds[n], single, jax_ref)


@pytest.mark.parametrize("n", [2, 4])
def test_expert_sharded_step_matches_unsharded(worlds, single, n):
    """A depth-1 step: the loss and every gradient (the experts gathered)
    equal the single process's, on every rank."""
    H.check_step(worlds[n], single)


@pytest.mark.parametrize("n", [2, 4])
def test_expert_sharded_step_matches_jax(worlds, jax_ref, n):
    H.check_step_jax(worlds[n], jax_ref)


@pytest.mark.parametrize("n", [2, 4])
def test_expert_sharded_evaluation(worlds, single, n):
    H.check_eval(worlds[n], single)


def test_gradient_tags(worlds, single):
    """An expert weight (sharded), a gate weight (partial on each expert
    rank: summed over the expert group too) and an encoder weight (whole):
    each reduced once, neither K times nor 0."""
    H.check_tags(worlds[2], single, {
        "sharded": "processor.0.experts.0.3.conv.weights1",
        "partial": "processor.0.gate.1.weight",
        "whole": "encoder.encoder.0.weight"})


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_pooled_gate_step_matches_unsharded(pooled_gate, ref):
    """Without static conditioning the gate pools the hidden state (JAX's
    ``test_moe_no_conditioning_pools_gate``), so each expert rank's
    gradient into a block's input holds only its part of the gate's path
    too: a depth-1 step's loss and every gradient, the encoder's and the
    earlier blocks' included, equal the single process's and JAX's."""
    world, single, jax_ref = pooled_gate
    assert single["grads"]["processor.0.gate.0.weight"].shape == (4, 16)
    if ref == "port":
        H.check_step(world, single)
    else:
        H.check_step_jax(world, jax_ref)


def test_checkpoint_resumes_in_one_process(worlds, data_dir):
    """The expert-parallel epoch's checkpoint holds the whole model and
    optimizer state, and one process resumes it."""
    H.check_checkpoint_resumes_in_one_process(worlds[2], data_dir, PORT_CFG)


def test_saved_checkpoint_is_whole(worlds, single):
    H.check_saved(worlds[2], single)


def test_trainer_expert_parallel_end_to_end(worlds):
    """train() for an epoch with its evaluation under expert_parallel=2:
    finite losses, the same on both ranks; a resume from its checkpoint
    starts at epoch 1 with the trained parameters and optimizer state, bit
    for bit."""
    a, b = (r["epoch"] for r in worlds[2]["ranks"])
    assert np.isfinite(a["train"]).all()
    assert a["train"] == b["train"] and a["val"] == b["val"]
    assert a["resumed_at"] == b["resumed_at"] == 1
    assert a["resumed_same"] and b["resumed_same"]


def test_refusals():
    """zero1 under expert parallelism, expert with pipeline parallelism,
    and expert parallelism without data parallelism or a process group
    raise."""
    from nps_tpu_torch.train.base import refuse_unported

    with pytest.raises(RuntimeError, match="P9b item 6"):
        refuse_unported(Namespace(data_parallel=True, expert_parallel=2))
    with pytest.raises(ValueError, match="zero1"):
        refuse_unported(Namespace(data_parallel=True, expert_parallel=2,
                                  zero1=True))
    with pytest.raises(NotImplementedError, match="P9b item 6"):
        refuse_unported(Namespace(data_parallel=True, expert_parallel=2,
                                  pipeline_parallel=2))


# ------------------------------------------------------ the model cases
@pytest.mark.parametrize("name,n", CASE_N)
def test_case_forward_matches_single_process_and_jax(worlds, name, n):
    """Each model case, its experts split over the expert axis, equals the
    port's single process and nps_tpu's."""
    H.check_case_forward(worlds[n], name, worlds["single"][name],
                         worlds["jax"][name])


@pytest.mark.parametrize("name,n", CASE_N)
def test_case_step_matches_single_process(worlds, name, n):
    """Each model case's depth-1 step: the loss, every gradient gathered
    whole, and every replicated gradient as each expert rank holds it."""
    H.check_case_step(worlds[n], name, worlds["single"][name])


@pytest.mark.parametrize("name,n", CASE_N)
def test_case_step_matches_jax(worlds, name, n):
    H.check_case_step_jax(worlds[n], name, worlds["jax"][name])


@pytest.mark.parametrize("n", [2, 4])
def test_bc_encoder_gradient_summed_over_the_expert_group(worlds, n):
    """The BC encoder's code reaches every expert's input and the gate; an
    expert rank runs only its experts, so its gradient into the code is
    partial: the block takes the conditioning through ``copy_in``, whose
    backward sums it over the expert group. On every rank each of the
    encoder's gradients, as the rank holds it, is the single process's
    (without the sum: a rank's own experts' part)."""
    ref = worlds["single"]["moe_bc"]["grads"]
    keys = [k for k in ref if k.startswith("bc_encoder.")]
    assert len(keys) == 6
    for res in worlds[n]["ranks"]:
        got = res["cases"]["moe_bc"]["replicated"]
        for k in keys:
            err = float((got[k] - ref[k]).abs().max() / ref[k].abs().max())
            assert err <= H.REL_GRAD, (k, err)


def test_3d_moe_experts_on_their_ranks(worlds, single):
    """The 3D MoE (2 experts a block): each expert rank holds one expert of
    every block, its four 3D spectral weights included."""
    whole = worlds["single"]["moe3d"]["grads"]
    experts = sum(v.numel() for k, v in whole.items() if ".experts." in k)
    total = sum(v.numel() for v in whole.values())
    assert any(k.endswith("conv.weights4") for k in whole)
    for res in worlds[2]["ranks"]:
        assert res["cases"]["moe3d"]["numel"] == total - experts // 2


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        H.worker(sys.argv[2], SCENARIOS)
