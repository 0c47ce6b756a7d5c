"""Rematerialization (``models/common.py:remat_block``) in every processor
that takes ``remat``, against the port without it and against ``nps_tpu``
with the same flags: the U-FNO under both policies (None and
``"save_conv_outputs"``), the Dilated ResNet, the FNO processor, and the
MP-GNN (per layer, and its edge chunks). Small sizes: 8 features, a 16 x 12
grid, 2 conditioning channels; the MP-GNN on a 40-node radius graph. The
port's weights are drawn from a seed and carried into the JAX modules
(``convert_state_dict``'s layouts).

Also: the ``"save_conv_outputs"`` policy keeps the conv outputs (the
backward runs no ``aten.convolution``; with the policy None it runs them
again), and the recompute runs in the compute dtype its forward ran in.

Bars: remat against no remat, loss and every gradient max|d| / max|ref| <=
1e-6 (the same ops on the same values; only the order in which autograd
frees and recomputes differs). Against JAX (ROADMAP "How a part is
held"): the loss <sum(out * dy)> rtol 2e-3, every gradient (input and
parameters) max|d| / max|ref| < 5e-3, a gradient below 1e-4 of the largest
held at that floor. JAX runs at precision "highest"; PyTorch on two
threads.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from nps_tpu.compat import convert_state_dict
from nps_tpu.models import dilated_resnet as jdrn
from nps_tpu.models import fno as jfno
from nps_tpu.models import gnn as jgnn
from nps_tpu.models import ufno as jufno
from nps_tpu_torch.common import graph as G
from nps_tpu_torch.compat.jax_weights import from_jax_params
from nps_tpu_torch.models import config as tconfig
from nps_tpu_torch.models.common import remat_block
from nps_tpu_torch.models.dilated_resnet import DilatedResnet
from nps_tpu_torch.models.fno import FNO
from nps_tpu_torch.models.gnn import MPGNN
from nps_tpu_torch.models.ufno import UFNO

REL_SELF, REL_LOSS, REL_GRAD = 1e-6, 2e-3, 5e-3
GRID, C, NC = (16, 12), 8, 2


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _rel(a, ref):
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


def _grid_case(kind, remat, policy=None):
    """(port module, JAX module) of one grid processor."""
    kw = dict(num_spatial_dims=2, n_cond=NC, hidden_features=C)
    if kind == "ufno":
        kw.update(hidden_blocks=1, fno_modes=3, ch_mults=(1,),
                  is_attn=(False,), norm=True)
        return (UFNO(remat=remat, remat_policy=policy, **kw),
                jufno.UFNO(remat=remat, remat_policy=policy, **kw))
    if kind == "drn":
        kw.update(hidden_blocks=1, kernel_size=3, padding_mode="circular")
        return (DilatedResnet(remat=remat, **kw),
                jdrn.DilatedResnet(remat=remat, **kw))
    kw.update(hidden_blocks=2, fno_modes=3)
    return FNO(remat=remat, **kw), jfno.FNO(remat=remat, **kw)


def _jax_params(module):
    """The port module's weights as the JAX module's parameter tree (the
    DRN's ``processor_b/layers/2l`` is ``block_b/conv_l`` there)."""
    params = convert_state_dict(module.state_dict())["params"]
    return {(k.replace("processor_", "block_") if k.startswith("processor_")
             else k): ({f"conv_{int(i) // 2}": p
                        for i, p in v["layers"].items()}
                       if k.startswith("processor_") else v)
            for k, v in params.items()}


def _seeded(module, seed):
    torch.manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters()
    return module


def _port_run(module, inputs, dy, call):
    """<out, dy> and the gradients of it (inputs first, then parameters by
    name), as numpy."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = call(module, *leaves)
    loss = (out * torch.from_numpy(dy)).sum()
    loss.backward()
    grads = {f"input{i}": t.grad.numpy() for i, t in enumerate(leaves)}
    grads.update({k: p.grad.numpy() for k, p in module.named_parameters()})
    return float(loss.detach()), grads


def _check_self(a, b):
    (loss_a, g_a), (loss_b, g_b) = a, b
    assert abs(loss_a - loss_b) <= REL_SELF * abs(loss_b)
    assert set(g_a) == set(g_b)
    for k, g in g_b.items():
        assert _rel(g_a[k], g) <= REL_SELF, k


def _check_jax(port, jloss, jgrads):
    """A gradient below 1e-4 of the largest (zero in exact arithmetic, f32
    noise on both sides: the U-Net's last shortcut bias, whose entries here
    are ~1e-5 of the largest gradient and differ by ~3e-7 of it) is held at
    that floor; ``test_torch_train.py`` holds the whole model at 1e-5,
    where the loss is the trainer's and not a random projection."""
    loss, grads = port
    np.testing.assert_allclose(loss, jloss, rtol=REL_LOSS)
    assert set(jgrads) == set(grads)
    floor = 1e-4 * max(np.abs(r).max() for r in jgrads.values())
    for k, ref in jgrads.items():
        scale = max(np.abs(ref).max(), floor)
        assert np.abs(grads[k] - ref).max() / scale < REL_GRAD, k


@pytest.mark.parametrize("kind,policy", [("ufno", "save_conv_outputs"),
                                         ("ufno", None), ("drn", None),
                                         ("fno", None)])
def test_grid_processor_remat_matches_no_remat_and_jax(kind, policy):
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, C) + GRID).astype(np.float32)
    vb = rng.standard_normal((2, NC) + GRID).astype(np.float32)
    dy = rng.standard_normal((2, C) + GRID).astype(np.float32)
    tm, jm = _grid_case(kind, True, policy)
    _seeded(tm, 2)
    plain = _grid_case(kind, False)[0]
    plain.load_state_dict(tm.state_dict())
    assert tm.remat and not plain.remat

    def call(m, h, vb):
        return m(h, variables_broadcast=vb)

    got = _port_run(tm, (h, vb), dy, call)
    _check_self(got, _port_run(plain, (h, vb), dy, call))

    cl = (lambda a: np.moveaxis(a, 1, -1))   # channels-last for JAX

    @jax.jit
    def value_and_grads(params, h, vb):
        def loss(params, h, vb):
            out = jm.apply({"params": params}, h, variables_broadcast=vb)
            return jnp.sum(out * cl(dy))
        return jax.value_and_grad(loss, argnums=(0, 1, 2))(params, h, vb)

    with jax.default_matmul_precision("highest"):
        jloss, (gp, gh, gvb) = value_and_grads(_jax_params(tm), cl(h), cl(vb))
    ref = {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, gp)).items()}
    ref["input0"] = np.moveaxis(np.asarray(gh), -1, 1)
    ref["input1"] = np.moveaxis(np.asarray(gvb), -1, 1)
    _check_jax(got, float(jloss), ref)


def _graph(seed=5, n=40):
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 2)).astype(np.float32)
    return pos, G.radius_graph(pos, 0.3)


@pytest.mark.parametrize("edge_chunks", [1, 4])
def test_mpgnn_remat_matches_no_remat_and_jax(edge_chunks):
    """MPGNN(remat=True) recomputes each layer (and, with edge_chunks > 1,
    each edge slice, as the JAX package always does) on the gather path."""
    pos, edges = _graph()
    n = pos.shape[0]
    rng = np.random.default_rng(6)
    h = rng.standard_normal((n, C)).astype(np.float32)
    vb = rng.standard_normal((n, NC)).astype(np.float32)
    dy = rng.standard_normal((n, C)).astype(np.float32)
    kw = dict(hidden_features=C, hidden_blocks=2, num_spatial_dims=2,
              n_cond=NC, edge_chunks=edge_chunks)
    jm = jgnn.MPGNN(remat=True, **kw)
    params = jax.jit(lambda h, vb: jm.init(
        jax.random.PRNGKey(0), h, variables_broadcast=vb, pos=pos,
        edge_index=edges))(h, vb)["params"]
    tm, plain = MPGNN(remat=True, **kw), MPGNN(remat=False, **kw)
    for m in (tm, plain):
        m.load_state_dict(from_jax_params(
            jax.tree_util.tree_map(np.asarray, params)))
    e = torch.from_numpy(edges).long()

    def call(m, h, vb):
        return m(h, variables_broadcast=vb, pos=torch.from_numpy(pos),
                 edge_index=e)

    got = _port_run(tm, (h, vb), dy, call)
    _check_self(got, _port_run(plain, (h, vb), dy, call))

    @jax.jit
    def value_and_grads(params, h, vb):
        def loss(params, h, vb):
            out = jm.apply({"params": params}, h, variables_broadcast=vb,
                           pos=pos, edge_index=edges)
            return jnp.sum(out * dy)
        return jax.value_and_grad(loss, argnums=(0, 1, 2))(params, h, vb)

    with jax.default_matmul_precision("highest"):
        jloss, (gp, gh, gvb) = value_and_grads(params, h, vb)
    ref = {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, gp)).items()}
    ref["input0"], ref["input1"] = np.asarray(gh), np.asarray(gvb)
    _check_jax(got, float(jloss), ref)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy,convs_again", [("save_conv_outputs", False),
                                                (None, True)])
def test_save_conv_outputs_keeps_the_convs(policy, convs_again):
    """Under "save_conv_outputs" the backward of a rematerialized U-FNO
    block runs no aten.convolution (the forward's outputs are kept) but
    recomputes the rest (the GroupNorm statistics); under None it runs the
    convs again."""
    tm = _seeded(_grid_case("ufno", True, policy)[0], 4)
    rng = np.random.default_rng(7)
    h, vb = (torch.from_numpy(rng.standard_normal((2, c) + GRID)
                              .astype(np.float32)).requires_grad_()
             for c in (C, NC))
    out = tm(h, variables_broadcast=vb)
    with _CountOps() as mode:
        out.square().sum().backward()
    assert (mode.ops["aten.convolution.default"] > 0) == convs_again
    assert mode.ops["aten.convolution_backward.default"] > 0
    assert mode.ops["aten.rsqrt.default"] > 0   # GroupNorm recomputed


def test_recompute_runs_in_the_forward_compute_dtype():
    """A block run under bf16 is recomputed in bf16 by a backward that runs
    after the scope has closed."""
    seen = []

    def block(x):
        seen.append(tconfig.compute_dtype())
        return torch.sin(tconfig.cast_compute(x))   # keeps its input

    x = torch.ones(3, requires_grad=True)
    with tconfig.compute_dtype_scope("bfloat16"):
        y = remat_block(block)(x)
    assert tconfig.compute_dtype() is None
    y.float().sum().backward()
    assert seen == [torch.bfloat16, torch.bfloat16]
    assert y.dtype == torch.bfloat16 and x.grad.dtype == torch.float32


def test_remat_block_refuses_an_unknown_policy():
    with pytest.raises(ValueError, match="remat policy"):
        remat_block(lambda x: x, "save_everything")
