"""The port's MP-GNN path against ``nps_tpu``'s (mirrors
``tests/test_gnn.py``): the static grid graph, the DataCreator graph API and
the graph helpers (host numpy, edge sets exactly equal), the model's two
message-passing paths, and the ``cfg_twophase_gnn`` family served and
trained at a small size (12x8 grid, time window 5, 21 frames, 2 blocks x 16
features), JAX weights carried into the port with ``from_jax_params``.

Bars (ROADMAP "How a part is held"): forward max|d| / max|ref| < 1e-4;
3-step rollout nRMSE < 1e-3; gradients max|d| / max|ref| < 5e-3 per
parameter; a depth-1 pushforward train step's loss rtol 2e-3. The shifted
and gather paths agree to rtol 2e-5 / atol 2e-6 (the JAX package's own bar
for that pair), and ``edge_chunks`` to rtol 1e-5 (forward) and 1e-4
(gradients). JAX runs at precision "highest"; PyTorch on two threads.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nps_tpu.common import graph as JG
from nps_tpu.common.data_creator import DataCreator as JaxDataCreator
from nps_tpu.configs.parse import parse_args as jax_parse_args
from nps_tpu.data.pipeline import HostDataLoader as JaxHostDataLoader
from nps_tpu.inference import SurrogateEngine as JaxEngine
from nps_tpu.models.gnn import MPGNN as JaxMPGNN
from nps_tpu.pde import PDE1D as JaxPDE1D
from nps_tpu.pde import PDE2D as JaxPDE2D
from nps_tpu.train.pushforward import window
from nps_tpu.train_cli import get_config_static as jax_build
from nps_tpu.utils.misc import grid_graph_to_array as jax_grid_to_array
from nps_tpu.utils.process_output import process_step as jax_process_step
from nps_tpu_torch import train_cli
from nps_tpu_torch.common import graph as G
from nps_tpu_torch.common.data_creator import DataCreator
from nps_tpu_torch.compat.jax_weights import from_jax_params
from nps_tpu_torch.configs.parse import parse_args as port_parse_args
from nps_tpu_torch.data.synthetic import generate
from nps_tpu_torch.inference import SurrogateEngine
from nps_tpu_torch.models.gnn import MPGNN
from nps_tpu_torch.pde import PDE1D, PDE2D
from nps_tpu_torch.utils.misc import grid_graph_to_array

NT, NX1, NX2, TW, B = 21, 12, 8, 5, 2
REL_FWD, NRMSE, REL_LOSS, REL_GRAD = 1e-4, 1e-3, 2e-3, 5e-3
JAX_CFG = "nps_tpu/configs/train/cfg_twophase_gnn.py"
PORT_CFG = "nps_tpu_torch/configs/train/cfg_twophase_gnn.py"
SMALL = ["--model.hidden_features=16", "--model.hidden_blocks=2"]
PDE_KW = dict(tmin=0, tmax=10, nt=NT, L1=1.0, L2=0.7, nx1=NX1, nx2=NX2,
              x=None, name="twophase", n_cond_static=2, n_cond_spatial=2)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _rel(a, ref):
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---- the static graph (host numpy) ------------------------------------------

@pytest.mark.parametrize("case", ["radius", "radius_capped", "knn",
                                  "radius_batched", "knn_batched"])
def test_edge_builders_equal_jax(case):
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(30, 2))
    batch = np.repeat([0, 1, 2], 10)
    calls = {
        "radius": lambda g: g.radius_graph(pos, 0.8),
        "radius_capped": lambda g: g.radius_graph(pos, 1.5,
                                                  max_num_neighbors=4),
        "knn": lambda g: g.knn_graph(pos, 4),
        "radius_batched": lambda g: g.radius_graph(pos, 1.0, batch=batch),
        "knn_batched": lambda g: g.knn_graph(pos, 3, batch=batch),
    }
    got, ref = calls[case](G), calls[case](JG)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32 and (np.diff(got[1]) >= 0).all()


def test_tile_edges_and_node_layout_equal_jax():
    rng = np.random.default_rng(1)
    e = G.radius_graph(rng.normal(size=(12, 2)), 0.9)
    np.testing.assert_array_equal(G.tile_edges(e, 12, 3),
                                  JG.tile_edges(e, 12, 3))
    u = rng.normal(size=(2, 3, 5, 4, 6)).astype(np.float32)
    nodes = G.grid_to_nodes(u)
    np.testing.assert_array_equal(nodes, JG.grid_to_nodes(u))
    np.testing.assert_array_equal(G.nodes_to_grid(nodes, 2, (4, 6)), u)
    t = G.grid_to_nodes(torch.from_numpy(u))
    np.testing.assert_array_equal(t.numpy(), nodes)
    np.testing.assert_array_equal(G.nodes_to_grid(t, 2, (4, 6)).numpy(), u)


@pytest.mark.parametrize("rule", [
    ("2d", "twophase", 2), ("2d", "NS", 1), ("2d", "NS", 2),
    ("1d", "CE", 2), ("1d", "WE", 2), ("1d", "WE", 3)])
def test_grid_edges_and_static_structure_equal_jax(rule):
    """The PDE-keyed edge rules (2D radius n*hypot(dx1, dx2) + 1e-4, 1D
    radius n*dx + 1e-4, WE knn) and build_static_structure's four outputs,
    grid_offset_structure included (None for the WE knn rule at k=3: its
    ties break the grid's symmetry)."""
    dims, name, n = rule
    if dims == "2d":
        kw = dict(tmin=0, tmax=1, nt=11, L1=1.0, L2=0.8, nx1=NX1, nx2=NX2,
                  x=None, name=name)
        pde, jpde = PDE2D(**kw), JaxPDE2D(**kw)
    else:
        kw = dict(tmin=0, tmax=1, nt=11, L=1.0, nx=16, x=None, name=name)
        pde, jpde = PDE1D(**kw), JaxPDE1D(**kw)
    np.testing.assert_array_equal(G.grid_edges(pde, pde.x, n),
                                  JG.grid_edges(jpde, jpde.x, n))
    got = G.build_static_structure(pde, pde.x, n, 3)
    ref = JG.build_static_structure(jpde, jpde.x, n, 3)
    for a, r in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(a, r)
    assert got[3] == ref[3]
    if (name, n) == ("WE", 3):
        assert got[3] is None


def test_twophase_grid_takes_the_shifted_path_with_24_offsets():
    """cfg_twophase_gnn's rule (neighbors=2) on the full 96x64 twophase
    grid: an offset-structured edge set of 24 offsets, equal to JAX's."""
    kw = dict(tmin=0, tmax=10, nt=501, L1=1.0, L2=64 / 96, nx1=96, nx2=64,
              x=None, name="twophase")
    pde, jpde = PDE2D(**kw), JaxPDE2D(**kw)
    meta = G.build_static_structure(pde, pde.x, 2, 1)[3]
    assert meta is not None and len(meta[1]) == 24
    assert meta == JG.build_static_structure(jpde, jpde.x, 2, 1)[3]


def test_grid_offset_structure_rejects_knn_ties():
    pde = PDE1D(tmin=0, tmax=1, nt=11, L=1.0, nx=16, x=None, name="WE")
    ei = G.grid_edges(pde, pde.x, 3)
    assert G.grid_offset_structure(pde.x, ei) is None
    assert JG.grid_offset_structure(pde.x, ei) is None


# ---- DataCreator and the graph helpers --------------------------------------

def test_create_graph_and_next_graph_equal_jax():
    rng = np.random.default_rng(2)
    kw = dict(tmin=0.0, tmax=2.0, nt=40, L1=1.0, L2=1.0, nx1=6, nx2=5,
              x=None, name="NS")
    pde, jpde = PDE2D(**kw), JaxPDE2D(**kw)
    args = dict(neighbors=1, time_window=3, t_resolution=40, x_resolution=6)
    dc, jdc = DataCreator(pde, **args), JaxDataCreator(jpde, **args)
    u = rng.normal(size=(2, 1, 40, 6, 5)).astype(np.float32)
    x = np.tile(pde.x[None], (2, 1, 1, 1))
    cond = rng.normal(size=(2, 4)).astype(np.float32)
    steps = [3, 9]
    data, labels = dc.create_data(u, steps)
    jdata, jlabels = jdc.create_data(u, steps)
    np.testing.assert_array_equal(data, jdata)
    g = dc.create_graph(data, labels, x, cond, steps)
    jg = jdc.create_graph(data, labels, x, cond, steps)
    for a, r in zip(g, jg):
        np.testing.assert_array_equal(a, r)

    steps2 = [s + 3 for s in steps]
    _, labels2 = dc.create_data(u, steps2)
    pred = G.grid_to_nodes(labels)
    g2 = dc.create_next_graph(g, pred, labels2, steps2)
    jg2 = jdc.create_next_graph(jg, pred, labels2, steps2)
    for a, r in zip(g2, jg2):
        np.testing.assert_array_equal(a, r)
    np.testing.assert_array_equal(g2.nodes, pred)
    # the same on torch tensors
    gt = g._replace(nodes=torch.from_numpy(g.nodes),
                    pos=torch.from_numpy(g.pos))
    g2t = dc.create_next_graph(gt, torch.from_numpy(pred), labels2, steps2)
    np.testing.assert_array_equal(g2t.nodes.numpy(), g2.nodes)
    np.testing.assert_array_equal(g2t.pos.numpy(), g2.pos)

    img = grid_graph_to_array(g.nodes, g.pos, g.batch, pde.dxs)
    np.testing.assert_array_equal(
        img, jax_grid_to_array(g.nodes, g.pos, g.batch, pde.dxs))
    np.testing.assert_allclose(img, data, rtol=1e-6)


# ---- the model's two paths -------------------------------------------------

def _loss_and_grads(model, fn):
    model.zero_grad()
    out = fn()
    out.square().sum().backward()
    return out.detach(), {k: p.grad.clone()
                          for k, p in model.named_parameters()}


def test_shifted_path_matches_gather_path():
    """On a regular grid, the shifted path (grid_meta) and the
    gather/index_add_ path: output and gradients."""
    nx1, nx2, b, c = 12, 10, 3, 16
    pde = PDE2D(tmin=0, tmax=1, nt=11, L1=1.0, L2=0.8, nx1=nx1, nx2=nx2,
                x=None, name="NS")
    edges, pos_n, _, meta = G.build_static_structure(pde, pde.x, 2, b)
    assert meta is not None and meta[0] == (nx1, nx2)
    torch.manual_seed(0)
    m = MPGNN(hidden_features=c, hidden_blocks=2, num_spatial_dims=2)
    h = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (b * nx1 * nx2, c)).astype(np.float32))
    pos = torch.from_numpy(pos_n[:, 1:])
    ei = torch.from_numpy(edges).long()
    out_g, grads_g = _loss_and_grads(m, lambda: m(h, pos=pos, edge_index=ei))
    out_s, grads_s = _loss_and_grads(m, lambda: m(h, pos=pos, edge_index=ei,
                                                  grid_meta=meta))
    torch.testing.assert_close(out_s, out_g, rtol=2e-5, atol=2e-6)
    for k, g in grads_g.items():
        torch.testing.assert_close(grads_s[k], g, rtol=2e-4, atol=2e-5,
                                   msg=k)


def test_edge_chunks_match_unchunked():
    rng = np.random.default_rng(4)
    n, c = 30, 8
    pos = rng.random((n, 2)).astype(np.float32)
    edges = torch.from_numpy(G.radius_graph(pos, 0.4)).long()
    h = torch.from_numpy(rng.random((n, c)).astype(np.float32))
    pos = torch.from_numpy(pos)
    torch.manual_seed(1)
    m1 = MPGNN(hidden_features=c, hidden_blocks=2, num_spatial_dims=2)
    mk = MPGNN(hidden_features=c, hidden_blocks=2, num_spatial_dims=2,
               edge_chunks=5)
    mk.load_state_dict(m1.state_dict())
    out1, g1 = _loss_and_grads(m1, lambda: m1(h, pos=pos, edge_index=edges))
    outk, gk = _loss_and_grads(mk, lambda: mk(h, pos=pos, edge_index=edges))
    torch.testing.assert_close(outk, out1, rtol=1e-5, atol=1e-6)
    for k, g in g1.items():
        torch.testing.assert_close(gk[k], g, rtol=1e-4, atol=1e-6, msg=k)


@pytest.mark.parametrize("aggregate", ["mean", "sum"])
def test_gather_path_matches_jax(aggregate):
    """MPGNN alone on an irregular radius graph (the gather path), JAX
    weights carried over: output and the input's gradient."""
    rng = np.random.default_rng(5)
    n, c = 40, 16
    pos = rng.random((n, 2)).astype(np.float32)
    edges = G.radius_graph(pos, 0.3)
    h = rng.standard_normal((n, c)).astype(np.float32)
    vb = rng.standard_normal((n, 3)).astype(np.float32)
    jm = JaxMPGNN(hidden_features=c, hidden_blocks=2, aggregate=aggregate,
                  num_spatial_dims=2, n_cond=3)
    params = jm.init(jax.random.PRNGKey(0), h, variables_broadcast=vb,
                     pos=pos, edge_index=edges)

    def jfn(h):
        return jm.apply(params, h, variables_broadcast=vb, pos=pos,
                        edge_index=edges)

    with jax.default_matmul_precision("highest"):
        ref, vjp = jax.vjp(jfn, jnp.asarray(h))
        (ref_dh,) = vjp(jnp.ones_like(ref))
    tm = MPGNN(hidden_features=c, hidden_blocks=2, aggregate=aggregate,
               num_spatial_dims=2, n_cond=3)
    tm.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    th = torch.from_numpy(h).requires_grad_(True)
    out = tm(th, variables_broadcast=torch.from_numpy(vb),
             pos=torch.from_numpy(pos),
             edge_index=torch.from_numpy(edges).long())
    out.sum().backward()
    assert _rel(out.detach().numpy(), np.asarray(ref)) < REL_FWD
    assert _rel(th.grad.numpy(), np.asarray(ref_dh)) < REL_GRAD


def test_remat_is_refused():
    """The name is older than remat and bf16 in the MP-GNN: ``remat=True``
    is taken and applied per layer (the output and gradients against the
    JAX package's rematerialized layers in f32 are in
    ``test_torch_remat.py``), and a bf16 compute dtype is taken too: the
    rematerialized layers on the gather path in bf16 against JAX's, output
    and the input's gradient at the bf16 bar of ``test_torch_dtype.py``
    (|port_bf16 - JAX_bf16| / max|JAX_f32| <= max(2 d_jax, 8e-3))."""
    from nps_tpu.models import config as jconfig
    from nps_tpu_torch.models import config

    pos, edges = _radius_case()
    rng = np.random.default_rng(6)
    h = rng.standard_normal((pos.shape[0], 8)).astype(np.float32)
    dy = rng.standard_normal(h.shape).astype(np.float32)
    jm = JaxMPGNN(hidden_features=8, hidden_blocks=2, num_spatial_dims=2,
                  remat=True)
    jpos, jedges = pos.numpy(), edges.numpy()
    params = jm.init(jax.random.PRNGKey(0), h, pos=jpos, edge_index=jedges)
    ref = {}
    try:
        for dtype in (None, "bfloat16"):
            jconfig.set_compute_dtype(dtype)

            @jax.jit
            def value_and_vjp(h):
                y, vjp = jax.vjp(lambda h: jm.apply(
                    params, h, pos=jpos, edge_index=jedges), h)
                return y, vjp(jnp.asarray(dy).astype(y.dtype))[0]

            with jax.default_matmul_precision("highest"):
                y, dh = value_and_vjp(jnp.asarray(h))
            ref[dtype] = (np.asarray(y.astype(jnp.float32)),
                          np.asarray(dh.astype(jnp.float32)), str(y.dtype))
    finally:
        jconfig.set_compute_dtype(None)
    m = MPGNN(hidden_features=8, hidden_blocks=2, num_spatial_dims=2,
              remat=True)
    assert m.remat
    m.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    th = torch.from_numpy(h).requires_grad_(True)
    with config.compute_dtype_scope("bfloat16"):
        out = m(th, pos=pos, edge_index=edges)
        # an f32 input keeps the residual stream f32, on both sides
        assert str(out.dtype) == "torch." + ref["bfloat16"][2]
        (out.float() * torch.from_numpy(dy)).sum().backward()
    for got, j16, j32 in ((out.detach().float().numpy(), ref["bfloat16"][0],
                           ref[None][0]),
                          (th.grad.numpy(), ref["bfloat16"][1], ref[None][1])):
        scale = np.abs(j32).max()
        d_jax = np.abs(j16 - j32).max() / scale
        err = np.abs(got - j16).max() / scale
        assert err <= max(2 * d_jax, 8e-3), (err, d_jax)


def _radius_case(seed=4, n=30):
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 2)).astype(np.float32)
    return (torch.from_numpy(pos),
            torch.from_numpy(G.radius_graph(pos, 0.4)).long())


# ---- the cfg_twophase_gnn family against nps_tpu -----------------------------

def _parse(fn, cfg, argv):
    saved = sys.argv
    try:
        sys.argv = ["prog", *argv]
        return fn(cfg)
    finally:
        sys.argv = saved


def test_config_parses_to_the_jax_dict():
    def parse(fn, cfg):
        args = _parse(fn, cfg, [])
        return {g: {k: (type(v).__name__ if hasattr(v, "_parse_override")
                        else v) for k, v in args[g].items()}
                if isinstance(args[g], dict) else args[g] for g in args}

    assert parse(port_parse_args, PORT_CFG) == parse(jax_parse_args, JAX_CFG)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("gnn")
    generate(str(root / "data" / "twophase"), n_sims=8, n_channels=1, nt=NT,
             nx1=NX1, nx2=NX2, seed=5)
    return root


def _argv(data_dir, extra=()):
    return [f"--base_resolution=[{NT},{NX1},{NX2}]",
            f"--super_resolution=[{NT},{NX1},{NX2}]",
            f"--time_window={TW}", f"--batch_size={B}",
            f"--dataset.base_path={data_dir / 'data'}",
            "--dataset.c_filter=[0]", *SMALL,
            f"--experiment_path={data_dir / 'out'}",
            "--experiment_name=run", *extra]


@pytest.fixture(scope="module")
def family(data_dir):
    """Both trainers on the same split, the port's weights carried over from
    the JAX model's, and one batch."""
    argv = _argv(data_dir)
    jt = jax_build(_parse(jax_parse_args, JAX_CFG, argv))[5]
    pt = train_cli.get_config_static(_parse(port_parse_args, PORT_CFG, argv),
                                     device="cpu")[4]
    batch = next(iter(JaxHostDataLoader(jt.data.train, B, seed=0,
                                        process_index=0, process_count=1)))
    with jax.default_matmul_precision("highest"):
        jt.init_params(batch)
    params0 = jax.tree_util.tree_map(np.asarray, jt.params)
    pt.load_jax_params(params0)
    pt.set_optimizer(dict(object="optim.Adam", lr=1e-4))
    return jt, pt, batch, params0


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    u0 = (0.1 + 0.8 * rng.random((B, 1, TW, NX1, NX2))).astype(np.float32)
    cond = rng.random((B, 2)).astype(np.float32)
    return u0, cond


def test_engine_forward_and_rollout_match_jax(family):
    """The serving step against the JAX rollout's first step, and the whole
    3-step rollouts; the engine takes the shifted path on this grid."""
    *_, params0 = family
    over = [f"--time_window={TW}", *SMALL]
    jeng = JaxEngine.from_config(JAX_CFG, pde=JaxPDE2D(**PDE_KW),
                                 overrides=over)
    jeng.params = jax.tree_util.tree_map(jnp.asarray, params0)
    teng = SurrogateEngine.from_config(PORT_CFG, pde=PDE2D(**PDE_KW),
                                       overrides=over, device="cpu")
    teng.load_jax_params(params0)
    assert teng._is_gnn() and teng.neighbors == 2
    u0, cond = _inputs()
    with jax.default_matmul_precision("highest"):
        ref_roll = jeng.rollout(u0, n_steps=3, cond=cond)
    out = teng.step(u0, cond=cond)
    assert out.shape == (B, 1, TW, NX1, NX2)
    assert _rel(out, ref_roll[:, :, :TW]) < REL_FWD
    assert teng._ensure_graph(B)[3] is not None
    roll = teng.rollout(u0, n_steps=3, cond=cond)
    assert roll.shape == ref_roll.shape == (B, 1, 3 * TW, NX1, NX2)
    nrmse = np.sqrt(np.mean((roll - ref_roll) ** 2) / np.mean(ref_roll ** 2))
    assert nrmse < NRMSE
    # spatial conditioning is warned about and ignored, as in the reference
    sc = np.ones((B, 2, NX1, NX2), np.float32)
    with pytest.warns(UserWarning, match="spatial conditioning"):
        np.testing.assert_array_equal(teng.step(u0, cond=cond,
                                                spatial_cond=sc), out)


def test_train_step_matches_jax(family):
    """A depth-1 pushforward train step: the loss against the JAX loss (and
    the shipped JAX step's), every gradient against jax.grad."""
    jt, pt, batch, params0 = family
    pt.load_jax_params(params0)
    pt._build_optimizer()
    _, u, x, cond, t_cond, sc = (jnp.asarray(a) for a in batch)
    jt._ensure_graph_static(np.asarray(batch[2]), B)
    pde, mi = jt.data.pde, jt.model.model_interface
    steps0 = np.random.default_rng(6).integers(TW, NT - 2 * TW + 1, B)

    def loss_fn(p):
        def apply(d):
            return jt._apply(p, d, cond, None, x, None, sc)

        steps = jnp.asarray(steps0)
        data, labels = window(u, steps, TW, "both")
        pred = jax.lax.stop_gradient(apply(data))
        labels_prev, steps = labels, steps + TW
        labels = window(u, steps, TW, "labels")
        data, _ = jax_process_step(pde, mi, pred, labels_prev, labels,
                                   process_settings={})
        pred, _ = jax_process_step(pde, mi, apply(data), labels, None,
                                   get_bc=False, process_settings={})
        return jnp.sqrt(jt.criterion(pred, labels))

    with jax.default_matmul_precision("highest"):
        loss_ref, grads = jax.value_and_grad(loss_fn)(jt.params)
    loss, _ = pt.train_step(
        tuple(torch.from_numpy(np.asarray(a)) for a in batch), 0, 0,
        unrolled=1, steps0=torch.from_numpy(steps0))
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=REL_LOSS)
    ref = {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, grads)).items()}
    got = {k: p.grad.numpy() for k, p in pt.model.named_parameters()}
    assert set(got) == set(ref)
    floor = 1e-5 * max(np.abs(r).max() for r in ref.values())
    for k, g in got.items():
        scale = max(np.abs(ref[k]).max(), floor)
        assert np.abs(g - ref[k]).max() / scale < REL_GRAD, k


def test_test_step_and_simulate_match_jax(family):
    jt, pt, batch, params0 = family
    pt.load_jax_params(params0)
    jt.params = jax.tree_util.tree_map(jnp.asarray, params0)
    with jax.default_matmul_precision("highest"):
        loss_ref, info_ref = jt.test_step(
            tuple(jnp.asarray(a) for a in batch), 0)
    loss, info = pt.test_step(
        tuple(torch.from_numpy(np.asarray(a)) for a in batch), 0)
    assert set(info) == set(info_ref)
    for k, v in info_ref.items():
        np.testing.assert_allclose(info[k], v, rtol=REL_LOSS, atol=1e-12,
                                   err_msg=k)
    _, u, x, cond, _, sc = batch
    kw = dict(compute_loss=True, include_data=True, nr_gt_steps=1,
              t_res=NT, spatial_conditioning=sc)
    with jax.default_matmul_precision("highest"):
        losses_ref, (_, ref) = jt.simulate(u, cond, x, **kw)
    losses, (_, out) = pt.simulate(u, cond, x, **kw)
    nrmse = np.sqrt(np.mean((out - ref) ** 2) / np.mean(ref ** 2))
    assert nrmse < NRMSE
    np.testing.assert_allclose(losses, losses_ref, rtol=REL_LOSS)


def test_cli_trains_one_epoch_on_cpu(data_dir):
    """One epoch of cfg_twophase_gnn through the port's CLI on the CPU: a
    finite train and validation loss, a metrics line and the saved model."""
    import os

    argv = ["prog", "-C", PORT_CFG, "--device", "cpu",
            *_argv(data_dir, ["--trainer.num_epochs=1",
                              "--trainer.test_interval=1",
                              "--experiment_name=cli"])]
    trainer = train_cli.cli(argv)
    save = trainer.config.save_path
    with open(save + "_metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows] == [0]
    assert np.isfinite(rows[0]["train_loss"])
    assert np.isfinite(rows[0]["default - val loss"])
    assert os.path.exists(save + "_default.pt")
