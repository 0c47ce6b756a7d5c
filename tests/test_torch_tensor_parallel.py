"""Tensor parallelism in the port (``nps_tpu_torch.parallel.tensor``): the
output channels of the weights split over a model axis, in real gloo
worlds on the CPU of K = 2 (two processes) and of 2 data slices x K = 2
(four), held against the port's single-process forward, train step and
evaluation and against ``nps_tpu``'s forward and ``jax.grad``, with the
harness, sizes and bars of ``torch_grid_harness.py``. The cases mirror
``tests/test_tensor_parallel.py``: the partition rules, the forward, the
gradient step; besides, the gather of the shards is the whole state, bit
for bit, and so is the saved checkpoint, each parameter tag's gradient is
reduced once, every grid family that the rule splits gives its unsplit
forward, and the refusals. The worlds also run the model cases (the
harness's ``CASES``): the MP-GNN, the attention U-Net (a rank's share of
its projection straddling q and k), the time-conditioned U-FNO (its BC
encoder split too) and the 3D FNO and DRN, each against one process and
JAX, with its split leaves held to JAX's rule.
"""

import os
import sys
from argparse import Namespace

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_grid_harness as H  # noqa: E402

JAX_CFG = "nps_tpu/configs/train/cfg_twophase_ufno.py"
PORT_CFG = "nps_tpu_torch/configs/train/cfg_twophase_ufno.py"
FLAGS = ["--trainer.data_parallel=true", f"--trainer.tensor_parallel={H.K}"]


def sc_roundtrip(spec, g):
    """shard_state of the whole weights on this rank, then the trainer's
    gather over the model group: the whole weights (bit for bit, checked
    by the test), and the shares' shapes."""
    from nps_tpu_torch.parallel import tensor

    tr = H.grid_trainer(spec)
    whole = torch.load(spec["weights"], weights_only=True)
    specs = tr._specs   # the whole model's, taken before it was sharded
    local = tensor.shard_state(whole, tr.grid.axis, specs)
    return dict(gathered=tr._gather(local),
                shapes={k: tuple(v.shape) for k, v in local.items()},
                model_shapes={k: tuple(p.shape) for k, p in
                              tr.model.named_parameters()})


def sc_families(spec, g):
    """Each grid family the rule splits, sharded over the model axis, against
    its whole forward in this process (the same weights from the seed):
    max|d| / max|ref|."""
    from nps_tpu_torch import parallel
    from nps_tpu_torch.parallel import tensor
    from test_torch_spatial import FAMILIES, _engine, _rollout_inputs

    grid = parallel.Grid(H.K, "model")
    errs = {}
    for name, (cfg, n, ov) in FAMILIES.items():
        eng = _engine(cfg, n, ov)
        u0, cond, sc = (torch.from_numpy(a) for a in _rollout_inputs(n, 2))
        pos = eng._pos(2)
        with torch.no_grad():
            ref = eng.model(u0, cond=cond, pos=pos, spatial_cond=sc)
            specs = tensor.setup(eng.model, grid.axis)
            local = tensor.shard_state(eng.model.state_dict(), grid.axis,
                                       specs)
            for key, p in eng.model.named_parameters():
                p.data = local[key]
            with parallel.scope(grid.axis):
                got = eng.model(u0, cond=cond, pos=pos, spatial_cond=sc)
        errs[name] = float((got - ref).abs().max() / ref.abs().max())
    return errs


SCENARIOS = dict(H.COMMON, roundtrip=sc_roundtrip, families=sc_families)
# the models beside the U-FNO (torch_grid_harness.CASES): the MP-GNN, the
# attention U-Net, the time-conditioned U-FNO, the 3D FNO and DRN
CASES = ["gnn", "unet_attn", "ufno_tcond", "fno3d", "drn3d"]
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
    root = tmp_path_factory.mktemp("tensor")
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
    """K = 2 in a world of two (every scenario), D = 2 x K = 2 in a world of
    four; both run every model case (``CASES``) too."""
    return H.case_runs(__file__, data_dir, single, PORT_CFG, FLAGS,
                       {2: list(SCENARIOS), 4: ["forward", "step", "eval"]},
                       CASES)


# ------------------------------------------------------------------ tests
def _port_model():
    from test_torch_spatial import FAMILIES, _engine

    return _engine(*FAMILIES["ufno"]).model


def test_partition_spec_rules():
    """The JAX rule on the port's layouts: conv and dense weights split on
    axis 0, transposed-conv weights on axis 1, spectral weights on axis 2,
    a weight whose axis K does not divide stays whole, biases and norms
    replicated; the same leaves split as ``nps_tpu``'s
    ``param_partition_specs`` on the converted tree (count and elements)."""
    import jax

    from nps_tpu.compat import convert_state_dict
    from nps_tpu.parallel import param_partition_specs
    from nps_tpu_torch.models.common import ConvND, ConvTransposeND, Dense
    from nps_tpu_torch.models.fno import SpectralConvND
    from nps_tpu_torch.parallel import tensor

    model = _port_model()
    specs = tensor.partition_specs(model, H.K)
    kinds = {}
    for prefix, m in model.named_modules():
        for name, p in m.named_parameters(recurse=False):
            key = f"{prefix}.{name}" if prefix else name
            kinds[key] = (type(m), name, p.shape)
    seen = set()
    for key, d in specs.items():
        cls, name, shape = kinds[key]
        if name in ("weight", "weights1", "weights2") and cls in (
                ConvND, Dense, ConvTransposeND, SpectralConvND):
            want = {ConvND: 0, Dense: 0, ConvTransposeND: 1,
                    SpectralConvND: 2}[cls]
            assert d == (want if shape[want] % H.K == 0 else None), key
            seen.add((cls, d is None))
        else:
            assert d is None, key
    assert {(ConvND, False), (ConvND, True), (ConvTransposeND, False),
            (SpectralConvND, False)} <= seen

    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    tree = convert_state_dict(state)
    jspecs = param_partition_specs(tree, H.K)
    leaves = jax.tree_util.tree_leaves(tree)
    jflat = jax.tree_util.tree_leaves(
        jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    j_split = [np.size(a) for a, s in zip(leaves, jflat) if s != ()]
    p_split = [model.state_dict()[k].numel() for k, d in specs.items()
               if d is not None]
    assert len(j_split) == len(p_split) and sum(j_split) == sum(p_split)


def test_shards_gather_to_the_whole_state(worlds, single):
    """Each rank holds its share (half of every split axis), and the gather
    of the shards is the original state dict, bit for bit."""
    want = torch.load(single["weights"], weights_only=True)
    for res in worlds[2]["ranks"]:
        rt = res["roundtrip"]
        assert list(rt["gathered"]) == list(want)
        for k, v in want.items():
            assert torch.equal(rt["gathered"][k], v), k
        halved = [k for k, s in rt["shapes"].items()
                  if s != tuple(want[k].shape)]
        assert halved
        for k in halved:
            assert np.prod(rt["shapes"][k]) * H.K == want[k].numel()
            assert rt["model_shapes"][k] == rt["shapes"][k]


@pytest.mark.parametrize("n", [2, 4])
def test_tp_forward_matches_single_process_and_jax(worlds, single, jax_ref,
                                                   n):
    """The sharded forward equals the port's single-process forward and
    nps_tpu's."""
    H.check_forward(worlds[n], single, jax_ref)


@pytest.mark.parametrize("n", [2, 4])
def test_tp_grad_step_matches_single_process(worlds, single, n):
    """A depth-1 step: the loss and every gradient (the shards gathered)
    equal the single-process step's, on every rank."""
    H.check_step(worlds[n], single)


@pytest.mark.parametrize("n", [2, 4])
def test_tp_grad_step_matches_jax(worlds, jax_ref, n):
    """The step's loss and gradients against jax.grad of the JAX loss."""
    H.check_step_jax(worlds[n], jax_ref)


@pytest.mark.parametrize("n", [2, 4])
def test_tp_evaluation_matches_single_process(worlds, single, n):
    """The evaluation of the validation split: its loss and every
    per-step metric."""
    H.check_eval(worlds[n], single)


def test_gradient_tags(worlds, single):
    """A split weight (sharded: its shard's gradient) and a replicated bias
    (whole on every model rank): each reduced once over the data group,
    neither K times nor 0."""
    H.check_tags(worlds[2], single, {
        "sharded": "processor.0.fno_layers.0.conv.weights1",
        "replicated": "processor.0.fno_layers.0.w.bias"})


def test_checkpoint_resumes_in_one_process(worlds, data_dir):
    """The tensor-parallel epoch's checkpoint holds the whole model and
    optimizer state, and one process resumes it."""
    H.check_checkpoint_resumes_in_one_process(worlds[2], data_dir, PORT_CFG)


def test_saved_checkpoint_is_whole(worlds, single):
    """save_model on the model axis writes the whole state dict, bit for
    bit, which loads in one process."""
    H.check_saved(worlds[2], single)
    model = _port_model()
    model.load_state_dict(torch.load(worlds[2]["out"] / "saved.pt",
                                     weights_only=True))


def test_one_epoch_matches_on_every_rank(worlds):
    """train() for an epoch with its evaluation: finite losses, the same on
    both model ranks; a resume from its checkpoint starts at epoch 1 with
    the trained parameters and optimizer state, bit for bit."""
    a, b = (r["epoch"] for r in worlds[2]["ranks"])
    assert np.isfinite(a["train"]).all()
    assert a["train"] == b["train"] and a["val"] == b["val"]
    assert a["resumed_at"] == b["resumed_at"] == 1
    assert a["resumed_same"] and b["resumed_same"]


@pytest.mark.parametrize("family", ["ufno", "unet", "drn", "ufno_fno"])
def test_grid_families_sharded_forward(worlds, family):
    """Every grid family the rule splits (the U-FNO, the U-Net, the DRN and
    the FNO -> U-FNO chain) gives its whole forward at K = 2."""
    for res in worlds[2]["ranks"]:
        assert res["families"][family] <= H.REL_FWD


def test_refusals():
    """zero1 under tensor parallelism and tensor with spatial parallelism
    raise; the MP-GNN (its dense layers on node tensors) is taken."""
    from nps_tpu_torch.parallel import tensor
    from nps_tpu_torch.train.base import refuse_unported
    from test_torch_spatial import _engine

    with pytest.raises(RuntimeError, match="P9b item 4"):
        refuse_unported(Namespace(data_parallel=True, tensor_parallel=2))
    with pytest.raises(ValueError, match="data_parallel"):
        refuse_unported(Namespace(tensor_parallel=2))
    with pytest.raises(ValueError, match="zero1"):
        refuse_unported(Namespace(data_parallel=True, tensor_parallel=2,
                                  zero1=True))
    with pytest.raises(NotImplementedError, match="P9b item 4"):
        refuse_unported(Namespace(data_parallel=True, tensor_parallel=2,
                                  spatial_parallel=2))
    gnn = _engine("cfg_twophase_gnn.py", 16, ["--model.hidden_features=16",
                                              "--model.hidden_blocks=2"])
    tensor.check(gnn.model, H.K)


# ------------------------------------------------------ the model cases
@pytest.mark.parametrize("name,n", CASE_N)
def test_case_forward_matches_single_process_and_jax(worlds, name, n):
    """Each model case's forward of the first window, its layers split over
    the model axis, equals the port's single process and nps_tpu's."""
    H.check_case_forward(worlds[n], name, worlds["single"][name],
                         worlds["jax"][name])


@pytest.mark.parametrize("name,n", CASE_N)
def test_case_step_matches_single_process(worlds, name, n):
    """Each model case's depth-1 step: the loss, every gradient gathered
    whole, and every replicated gradient as each model rank holds it (the
    BC encoder's biases among them: whole on every model rank)."""
    H.check_case_step(worlds[n], name, worlds["single"][name])


@pytest.mark.parametrize("name,n", CASE_N)
def test_case_step_matches_jax(worlds, name, n):
    H.check_case_step_jax(worlds[n], name, worlds["jax"][name])


@pytest.mark.parametrize("name", CASES)
def test_case_partition_specs_match_jax(worlds, name):
    """Each case's split leaves are those of ``nps_tpu``'s
    ``param_partition_specs`` on its JAX tree (count and elements): the
    MP-GNN's dense kernels, the attention projections, the BC encoder's
    convs and dense layer, the 3D convs and all four 3D spectral weights;
    each split leaf holds 1 / K of its elements on a rank."""
    import jax

    from nps_tpu.parallel import param_partition_specs
    from nps_tpu_torch.parallel import tensor

    root = worlds[2]["out"].parent
    tr = H.case_trainer(name, root / "data", root / f"{name}_specs")
    specs = tensor.partition_specs(tr.model, H.K)
    tree = worlds["params0"][name]
    leaves = jax.tree_util.tree_leaves(tree)
    jflat = jax.tree_util.tree_leaves(
        param_partition_specs(tree, H.K),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    j_split = sorted(np.size(a) for a, s in zip(leaves, jflat) if s != ())
    state = tr.model.state_dict()
    p_split = sorted(state[k].numel() for k, d in specs.items()
                     if d is not None)
    assert j_split and j_split == p_split
    whole = sum(v.numel() for v in state.values())
    split = sum(p_split)
    for res in worlds[2]["ranks"]:
        assert res["cases"][name]["numel"] == whole - split // H.K


def test_gnn_gradient_tags(worlds):
    """The MP-GNN's split edge weights (their shards' gradients; the
    bias-free ``edge_0_send`` and ``edge_0_pos`` among them) and a
    replicated bias (whole on every model rank): each reduced once over the
    data group, neither K times nor 0."""
    ref = worlds["single"]["gnn"]["grads"]
    keys = [next(k for k in ref if k.endswith(tail)) for tail in (
        "mp.0.edge_0_send.weight", "mp.0.edge_0_pos.weight",
        "mp.1.edge.2.bias")]
    for n in (2, 4):
        for res in worlds[n]["ranks"]:
            got = res["cases"]["gnn"]["grads"]
            for key in keys:
                ratio = float(got[key].norm() / ref[key].norm())
                assert abs(ratio - 1) < 1e-3, (key, ratio)


def test_attention_projection_share_straddles_q_and_k(data_dir):
    """At the attention U-Net's 32 channels a model rank's share of the
    projection (48 of 96 outputs) holds all of q and half of k: the split
    into q, k and v comes after the gather, so the forward above does not
    depend on where the share ends."""
    from nps_tpu_torch.models.unet_modern import AttentionBlock
    from nps_tpu_torch.parallel import tensor

    tr = H.case_trainer("unet_attn", data_dir / "data", data_dir / "straddle")
    blocks = [m for m in tr.model.modules() if isinstance(m, AttentionBlock)]
    specs = tensor.partition_specs(tr.model, H.K)
    assert blocks
    for prefix, m in tr.model.named_modules():
        if isinstance(m, AttentionBlock):
            assert specs[f"{prefix}.projection.weight"] == 0
            assert specs[f"{prefix}.output.weight"] == 0
            share = 3 * m.d_k // H.K
            assert m.d_k < share < 2 * m.d_k


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        H.worker(sys.argv[2], SCENARIOS)
