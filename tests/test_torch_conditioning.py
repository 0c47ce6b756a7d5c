"""Boundary and time conditioning in the port against ``nps_tpu``: the
``BCEncoder``, ``EncProcDec`` with a BC encoder (1D with ``bc``, 1D with
``bc`` and ``t_cond`` together, 2D with ``t_cond`` through a small U-FNO,
the graph branch with ``t_cond`` through a small MP-GNN), ``t_cond`` ignored
without a BC encoder, the time-conditioned U-FNO
(``cfg_twophase_ufno_tcond``: ``cfg_twophase_ufno`` plus a ``t_conditioning``
memmap and a BC encoder) trained and evaluated by both trainers, the serving
engine's refusal, and the BC encoder in the pipeline's replicated encoder
stage in a gloo world of two (the counterpart of
``tests/test_pipeline_parallel.py::test_pipelined_bc_encoder_path``).

JAX weights go into the port through ``from_jax_params`` and back through
``convert_state_dict`` (bit for bit). The synthetic generator writes no
``t_conditioning`` file, so the split's is written here beside it (2
channels over the frames of each simulation). Bars (ROADMAP "How a part is
held"): forward max|d| / max|ref| < 1e-4, gradients < 5e-3 per tensor,
losses rtol 2e-3, rollout nRMSE < 1e-3; the pipelined world against one
process 1e-5 (forward) and 1e-4 (gradients). JAX runs at precision
"highest"; PyTorch on two threads (one in the world's ranks).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

NT, NX1, NX2, TW, B = 21, 24, 16, 5, 2
N_TC = 2   # time-conditioning channels
REL_FWD, REL_GRAD, REL_LOSS, NRMSE = 1e-4, 5e-3, 2e-3, 1e-3
REL_PP, REL_PP_GRAD = 1e-5, 1e-4
BC_SPEC = dict(object="BCEncoder", bc_encoder_out=4, bc_encoder_hidden=8,
               bc_encoder_kernel=3)
JAX_CFG = "nps_tpu/configs/train/cfg_twophase_ufno.py"
PORT_CFG = "nps_tpu_torch/configs/train/cfg_twophase_ufno_tcond.py"
SMALL = ["--model.hidden_features=8", "--model.hidden_blocks=2",
         "--model.fno_modes=4", "--model.bc_encoder.bc_encoder_out=4",
         "--model.bc_encoder.bc_encoder_hidden=8"]
WORKER_TIMEOUT = 300
CASES = ["1d_bc", "1d_bc_tcond", "2d_ufno_tcond", "graph_mpgnn_tcond"]


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_grads(got, ref_tree, floor_frac=1e-5):
    """Every parameter's gradient against the JAX tree's (carried into the
    port's names), a tensor below ``floor_frac`` of the largest held at
    that floor."""
    from nps_tpu_torch.compat.jax_weights import from_jax_params

    ref = {k: v.numpy() for k, v in from_jax_params(_tree_np(ref_tree))
           .items()}
    assert set(got) == set(ref)
    floor = floor_frac * max(np.abs(r).max() for r in ref.values())
    for k, g in got.items():
        scale = max(np.abs(ref[k]).max(), floor)
        assert np.abs(g - ref[k]).max() / scale < REL_GRAD, k


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


# ---- the BC encoder alone ----------------------------------------------------

def test_bc_encoder_forward_and_gradient():
    """[b, c_bc, tw] -> [b, out] with two hidden convs: output, the input's
    and every parameter's gradient against jax.vjp."""
    from nps_tpu.models.common import BCEncoder as JaxBCEncoder
    from nps_tpu_torch.compat.jax_weights import from_jax_params
    from nps_tpu_torch.models.common import BCEncoder

    rng = np.random.default_rng(0)
    kw = dict(bc_encoder_out=6, bc_encoder_hidden=8, bc_encoder_kernel=3,
              time_window=TW, bc_encoder_n_hidden=2, activation="gelu")
    x = rng.standard_normal((3, 4, TW)).astype(np.float32)
    dy = rng.standard_normal((3, 6)).astype(np.float32)
    jm = JaxBCEncoder(bc_encoder_in=4, **kw)
    params = jm.init(jax.random.PRNGKey(1), x)["params"]
    with jax.default_matmul_precision("highest"):
        ref, vjp = jax.vjp(lambda p, x: jm.apply({"params": p}, x),
                           params, jnp.asarray(x))
        g_params, g_x = vjp(jnp.asarray(dy))
    tm = BCEncoder(bc_encoder_in=4, **kw)
    state = from_jax_params({"bc_encoder": _tree_np(params)})
    tm.load_state_dict({k[len("bc_encoder."):]: v for k, v in state.items()},
                       strict=True)
    assert [k for k in tm.state_dict() if k.endswith("weight")] == [
        "bc_encoder.0.weight", "bc_encoder.2.weight", "bc_encoder.4.weight",
        "bc_encoder.7.weight"]
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt)
    (out * torch.from_numpy(dy)).sum().backward()
    assert _rel(out.detach().numpy(), ref) < REL_FWD
    assert _rel(xt.grad.numpy(), g_x) < REL_GRAD
    ref_g = from_jax_params({"bc_encoder": _tree_np(g_params)})
    for k, p in tm.named_parameters():
        assert _rel(p.grad.numpy(), ref_g["bc_encoder." + k]) < REL_GRAD, k
    with pytest.raises(ValueError, match="bc_encoder_in"):
        tm(torch.zeros(3, 5, TW))


# ---- EncProcDec with a BC encoder -------------------------------------------

def _pde1d(jax_side, name="DIV1Dish"):
    from nps_tpu.pde import PDE1D as JaxPDE1D
    from nps_tpu_torch.pde import PDE1D

    return (JaxPDE1D if jax_side else PDE1D)(
        tmin=0, tmax=4.0, nt=41, L=16.0, nx=32, x=None, name=name,
        n_cond_static=1, n_cond_dynamic=2)


def _pde2d(jax_side, n_dyn=N_TC):
    from nps_tpu.pde import PDE2D as JaxPDE2D
    from nps_tpu_torch.pde import PDE2D

    return (JaxPDE2D if jax_side else PDE2D)(
        tmin=0, tmax=10, nt=NT, L1=1.0, L2=0.7, nx1=NX1, nx2=NX2, x=None,
        name="twophase", n_cond_static=2, n_cond_spatial=2,
        n_cond_dynamic=n_dyn)


def _case(name):
    """(model kwargs, PDE maker, inputs) of a model case: the inputs are
    numpy arrays in the public layout, ``t_cond`` [b, c, tw]."""
    from nps_tpu.models.activations import GELU

    rng = np.random.default_rng(CASES.index(name))
    if name.startswith("1d"):
        spec = dict(BC_SPEC)
        if name == "1d_bc_tcond":
            spec["bc_encoder_in"] = 4   # bc's 2 channels and t_cond's 2
        kw = dict(encoder="enc_grid.ElementWise", processor="FNO",
                  decoder="dec_grid.TimeConvDense", bc_encoder=spec, num_c=2,
                  num_spatial_dims=1, time_window=TW, activation=GELU(),
                  hidden_features=16, fno_modes=4, hidden_blocks=1)
        inputs = dict(u=rng.random((B, 2, TW, 32), dtype=np.float32),
                      cond=rng.random((B, 1), dtype=np.float32),
                      bc=rng.random((B, 2, TW), dtype=np.float32))
        if name == "1d_bc_tcond":
            inputs["t_cond"] = rng.random((B, 2, TW), dtype=np.float32)
        inputs["pos"] = np.broadcast_to(_pde1d(True).x[None],
                                        (B, 32)).astype(np.float32)
        return kw, _pde1d, inputs
    pde = _pde2d(True)
    inputs = dict(
        u=(0.1 + 0.8 * rng.random((B, 1, TW, NX1, NX2))).astype(np.float32),
        cond=rng.random((B, 2)).astype(np.float32),
        t_cond=rng.random((B, N_TC, TW)).astype(np.float32))
    if name == "2d_ufno_tcond":
        kw = dict(encoder="enc_grid.ElementWise", processor="UFNO",
                  decoder="dec_grid.TimeConvDense", bc_encoder=BC_SPEC,
                  num_c=1, num_spatial_dims=2, time_window=TW,
                  activation=GELU(), hidden_features=8, hidden_blocks=1,
                  fno_modes=4, padding_mode="circular", ch_mults=[1, 1],
                  is_attn=[False, False], norm=True, use1x1=True,
                  dec_delta_mode="per_step")
        inputs["spatial_cond"] = (rng.random((B, 2, NX1, NX2)) > 0.8).astype(
            np.float32)
        inputs["pos"] = np.broadcast_to(pde.x[None].astype(np.float32),
                                        (B, NX1, NX2, 2)).copy()
        return kw, _pde2d, inputs
    from nps_tpu.models.activations import Swish

    kw = dict(encoder="gnn.NodeElementWise", processor="MPGNN",
              decoder="gnn.NodeTimeConvDense", bc_encoder=BC_SPEC, num_c=1,
              num_spatial_dims=2, time_window=TW, data_structure="graph",
              activation=Swish(), hidden_features=16, hidden_blocks=2,
              aggregate="mean", dec_delta_mode="per_step")
    return kw, _pde2d, inputs


def _port_kw(kw):
    """The model kwargs with the port's activation objects."""
    from nps_tpu_torch.models import activations

    return {k: (getattr(activations, type(v).__name__)()
                if hasattr(v, "_parse_override") else v)
            for k, v in kw.items()}


def _apply_pair(name):
    """(jax apply(params, inputs) -> grid output, port model, port apply
    (inputs of tensors) -> grid output, inputs, JAX params)."""
    import nps_tpu.models as jm
    from nps_tpu.common import graph as JG
    from nps_tpu_torch.common import graph as G
    from nps_tpu_torch.compat.jax_weights import from_jax_params
    from nps_tpu_torch.models.enc_proc_dec import EncProcDec

    kw, make_pde, inputs = _case(name)
    jmodel = jm.EncProcDec(pde=make_pde(True), **kw)
    tmodel = EncProcDec(pde=make_pde(False), **_port_kw(kw))
    if kw.get("data_structure") == "graph":
        jpde = make_pde(True)
        edges, pos_n, batch, meta = JG.build_static_structure(
            jpde, jpde.x, 2, B)
        structure = G.structure_on("cpu", make_pde(False), jpde.x, 2, B)

        def jax_apply(params, inp):
            graph = JG.GridGraph(nodes=JG.grid_to_nodes(inp["u"]),
                                 edge_index=edges, pos=pos_n, batch=batch)
            out = jmodel.apply(params, graph, cond=inp["cond"],
                               t_cond=inp["t_cond"], grid_meta=meta)
            return JG.nodes_to_grid(out, B, (NX1, NX2))

        def port_apply(inp):
            return G.apply_on_grid(tmodel, inp["u"], structure,
                                   cond=inp["cond"], t_cond=inp["t_cond"])

        def init():
            graph = JG.GridGraph(nodes=JG.grid_to_nodes(inputs["u"]),
                                 edge_index=edges, pos=pos_n, batch=batch)
            return jmodel.init(jax.random.PRNGKey(0), graph,
                               cond=inputs["cond"], t_cond=inputs["t_cond"],
                               grid_meta=meta)
    else:
        def jax_apply(params, inp):
            return jmodel.apply(params, **inp)

        def port_apply(inp):
            return tmodel(**inp)

        def init():
            return jmodel.init(jax.random.PRNGKey(0), **inputs)

    params = _tree_np(jax.jit(init)())
    tmodel.load_state_dict(from_jax_params(params), strict=True)
    return jax_apply, tmodel, port_apply, inputs, params


def _f64_vjp(jax_apply, params, inputs, dy):
    """JAX's gradient of every parameter for the cotangent ``dy``, computed
    in float64 (f64 parameters, inputs and cotangent) inside an x64 scope
    that no other test sees: the truth the port's f32 gradients are held
    to. JAX's own f32 gradients sit at f32 round-off from it, as the port's
    do, and a tensor near the bar's floor can then be farther from JAX's
    f32 result than from the truth (the U-FNO's smallest bias gradient: JAX
    f32 1.76e-6 from the f64 result, the port 4.7e-7)."""
    def f64(a):
        a = np.asarray(a)
        return a.astype(np.float64) if a.dtype == np.float32 else a

    def grads(p, inp, dy):
        return jax.vjp(lambda p: jax_apply(p, inp), p)[1](dy)[0]

    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        return _tree_np(jax.jit(grads)(
            jax.tree_util.tree_map(f64, params),
            {k: f64(v) for k, v in inputs.items()}, jnp.asarray(f64(dy))))


@pytest.mark.parametrize("name", CASES)
def test_enc_proc_dec_with_bc_encoder(name):
    """Forward (against JAX's f32), every gradient (against JAX's in
    float64, ``_f64_vjp``, for the same cotangent) and the weights' round
    trip through convert_state_dict, bit for bit (for the MP-GNN the BC
    encoder's: the JAX package's converter knows no GNN layer names)."""
    from nps_tpu.compat import convert_state_dict

    jax_apply, tmodel, port_apply, inputs, params = _apply_pair(name)
    assert "bc_encoder" in params["params"]
    with jax.default_matmul_precision("highest"):
        ref = jax_apply(params, inputs)
    dy = np.random.default_rng(1).standard_normal(ref.shape).astype(
        np.float32)
    g_params = _f64_vjp(jax_apply, params, inputs, dy)
    out = port_apply({k: torch.from_numpy(v) for k, v in inputs.items()})
    (out * torch.from_numpy(dy)).sum().backward()
    assert out.shape == ref.shape
    assert _rel(out.detach().numpy(), ref) < REL_FWD
    _assert_grads({k: p.grad.numpy() for k, p in tmodel.named_parameters()},
                  g_params)
    back, tree = convert_state_dict(tmodel.state_dict())["params"], params[
        "params"]
    if name.startswith("graph"):
        back, tree = back["bc_encoder"], tree["bc_encoder"]
    flat = jax.tree_util.tree_flatten_with_path(back)[0]
    ref_flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert len(flat) == len(ref_flat)
    for path, v in flat:
        np.testing.assert_array_equal(v, ref_flat[path],
                                      err_msg=jax.tree_util.keystr(path))


def test_t_cond_without_bc_encoder_is_ignored():
    """Without a BC encoder the port, as JAX, ignores ``bc`` and ``t_cond``;
    with one and neither signal, the port refuses (its processors take the
    encoder's channels)."""
    import nps_tpu.models as jm
    from nps_tpu_torch.compat.jax_weights import from_jax_params
    from nps_tpu_torch.models.enc_proc_dec import EncProcDec

    kw, make_pde, inputs = _case("2d_ufno_tcond")
    kw = {k: v for k, v in kw.items() if k != "bc_encoder"}
    jmodel = jm.EncProcDec(pde=make_pde(True), **kw)
    bare = {k: v for k, v in inputs.items() if k != "t_cond"}
    params = _tree_np(jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                  **bare))())
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jmodel.apply(params, **bare))
        np.testing.assert_array_equal(
            np.asarray(jmodel.apply(params, **inputs)), ref)
    tmodel = EncProcDec(pde=make_pde(False), **_port_kw(kw))
    tmodel.load_state_dict(from_jax_params(params), strict=True)
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with torch.no_grad():
        out = tmodel(**t).numpy()
        np.testing.assert_array_equal(
            tmodel(**{k: v for k, v in t.items() if k != "t_cond"}).numpy(),
            out)
    assert _rel(out, ref) < REL_FWD
    kw, make_pde, inputs = _case("2d_ufno_tcond")
    with_bc = EncProcDec(pde=make_pde(False), **_port_kw(kw))
    with pytest.raises(ValueError, match="neither bc nor t_cond"):
        with_bc(**{k: torch.from_numpy(v) for k, v in inputs.items()
                   if k != "t_cond"})


def _grid_model(piece):
    """A small 2D U-FNO (3D FNO for "3d", 3D MoE for "moe3d", MoE for
    "moe_bc") carrying the piece, two blocks."""
    from nps_tpu_torch.models.enc_proc_dec import EncProcDec

    kw, make_pde, _ = _case("2d_ufno_tcond")
    kw = dict(_port_kw(kw), hidden_blocks=2)
    if piece == "attention":
        kw = dict(kw, bc_encoder=None, is_attn=[True, False])
    elif piece in ("3d", "moe3d"):
        from nps_tpu_torch.pde import PDE3D

        return EncProcDec(
            pde=PDE3D(tmin=0, tmax=1, nt=11, L1=1, L2=1, L3=1, nx1=8, nx2=8,
                      nx3=8, x=None, name="box3d", n_cond_static=2),
            encoder="enc_grid.ElementWise",
            processor="FNO" if piece == "3d" else "MoEFNO", n_experts=2,
            decoder="dec_grid.TimeConvDense", num_c=1, num_spatial_dims=3,
            time_window=TW, hidden_features=8, fno_modes=2, hidden_blocks=2)
    elif piece == "moe_bc":
        kw = dict(kw, processor="MoEFNO", n_experts=2)
    return EncProcDec(pde=make_pde(False), **kw)


@pytest.mark.parametrize("regime,piece", [
    ("spatial", "attention"), ("spatial", "bc"), ("spatial", "3d"),
    ("spatial", "moe3d"), ("tensor", "attention"), ("tensor", "bc"),
    ("tensor", "3d"), ("expert", "moe_bc"), ("expert", "moe3d"),
    ("pipeline", "attention"), ("pipeline", "3d"), ("pipeline", "bc")])
def test_grid_regimes_take_or_refuse_the_pieces(regime, piece):
    """Each grid regime's check: every regime takes every piece (held in
    worlds against one process and JAX: the pipeline's BC encoder by
    test_pipelined_bc_encoder_path, spatial parallelism's, the 3D models
    included, by test_torch_spatial_families.py, the tensor, pipeline and
    expert cases by test_torch_{tensor,pipeline,expert}_parallel.py)."""
    from nps_tpu_torch.parallel import expert, pipeline, spatial, tensor

    model = _grid_model(piece)
    check = {"spatial": lambda m: spatial.check_model(m, None, 2),
             "tensor": lambda m: tensor.check(m, 2),
             "expert": lambda m: expert.check(m, 2),
             "pipeline": lambda m: pipeline.check(m, 2)}[regime]
    check(model)


# ---- the time-conditioned U-FNO, trained ------------------------------------

def _parse(fn, cfg, argv):
    saved = sys.argv
    try:
        sys.argv = ["prog", *argv]
        return fn(cfg)
    finally:
        sys.argv = saved


def _jax_args(argv):
    """The JAX package's cfg_twophase_ufno with the time-conditioned
    config's two entries (no JAX config file ships them)."""
    from nps_tpu.configs.parse import parse_args as jax_parse_args

    args = _parse(jax_parse_args, JAX_CFG,
                  [a for a in argv if not a.startswith("--model.bc_encoder")])
    args["dataset"]["t_conditioning"] = "t_conditioning"
    args["model"]["bc_encoder"] = dict(
        object="BCEncoder", bc_encoder_out=4, bc_encoder_hidden=8,
        bc_encoder_kernel=3, bc_encoder_n_hidden=1)
    return args


def write_t_conditioning(root, n_sims, nt, seed):
    """The ``t_conditioning`` memmap [n_sims, N_TC, nt] beside a generated
    split."""
    rng = np.random.default_rng(seed)
    np.save(os.path.join(root, "t_conditioning.npy"),
            rng.standard_normal((n_sims, N_TC, nt)).astype(np.float32))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    from nps_tpu_torch.data.synthetic import generate

    root = tmp_path_factory.mktemp("tcond")
    generate(str(root / "data" / "twophase"), n_sims=8, n_channels=1, nt=NT,
             nx1=NX1, nx2=NX2, seed=4)
    write_t_conditioning(root / "data" / "twophase", 8, NT, 5)
    return root


def _argv(data_dir, extra=()):
    return [f"--base_resolution=[{NT},{NX1},{NX2}]",
            f"--super_resolution=[{NT},{NX1},{NX2}]",
            f"--time_window={TW}", f"--batch_size={B}",
            f"--dataset.base_path={data_dir / 'data'}",
            "--dataset.c_filter=[0]", *SMALL,
            f"--experiment_path={data_dir / 'out'}", "--experiment_name=run",
            *extra]


@pytest.fixture(scope="module")
def trainers(data_dir):
    """Both trainers of the time-conditioned U-FNO on the same split, the
    port's weights carried over from the JAX model's, and one batch."""
    from nps_tpu.data.pipeline import HostDataLoader as JaxHostDataLoader
    from nps_tpu.train_cli import get_config_static as jax_build
    from nps_tpu_torch import train_cli
    from nps_tpu_torch.configs.parse import parse_args as port_parse_args

    argv = _argv(data_dir)
    jt = jax_build(_jax_args(argv))[5]
    pt = train_cli.get_config_static(_parse(port_parse_args, PORT_CFG, argv),
                                     device="cpu")[4]
    batch = next(iter(JaxHostDataLoader(jt.data.train, B, seed=0,
                                        process_index=0, process_count=1)))
    assert batch[4].shape == (B, N_TC, NT)
    with jax.default_matmul_precision("highest"):
        jt.init_params(batch)
    params0 = _tree_np(jt.params)
    assert "bc_encoder" in params0["params"]["inner"]
    pt.load_jax_params(params0)
    pt.set_optimizer(dict(object="optim.Adam", lr=1e-4))
    return jt, pt, batch, params0


def test_config_parses_to_the_jax_dicts():
    """The port's time-conditioned config is cfg_twophase_ufno's dicts (the
    JAX package's) with the two entries, key for key; its PDE has the
    memmap's two dynamic channels."""
    from nps_tpu_torch.configs.parse import parse_args as port_parse_args

    def plain(args):
        return {g: {k: (type(v).__name__ if hasattr(v, "_parse_override")
                        else v) for k, v in args[g].items()}
                if isinstance(args[g], dict) else args[g] for g in args}

    port = _parse(port_parse_args, PORT_CFG, SMALL)
    jax_args = _jax_args(SMALL)
    assert plain(port) == plain(jax_args)


def test_port_dataset_reads_t_conditioning_as_jax(trainers):
    """The loader's elements and the PDE's n_cond_dynamic, as JAX's."""
    jt, pt, _, _ = trainers
    assert pt.data.pde.n_cond_dynamic == jt.data.pde.n_cond_dynamic == N_TC
    for got, ref in zip(pt.data.train[1], jt.data.train[1]):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def _jax_loss_and_grads(jt, batch, depth, steps0):
    """The shipped step's loss rebuilt eagerly, each apply with its labels'
    window of t_cond (``nps_tpu/train/pushforward.py:324-330``), and
    jax.grad of it."""
    from nps_tpu.train.pushforward import window
    from nps_tpu.utils.process_output import process_step as jax_step

    _, u, x, cond, tc, sc = (jnp.asarray(a) for a in batch)
    pde, mi = jt.data.pde, jt.model.model_interface

    def apply(p, d, steps):
        return jt.model.apply(p, d, cond=cond, bc=None, pos=x,
                              t_cond=window(tc, steps, TW, "labels"),
                              spatial_cond=sc)

    steps = jnp.asarray(steps0)
    data, labels = window(u, steps, TW, "both")
    for _ in range(depth):
        pred = apply(jt.params, data, steps)
        labels_prev, steps = labels, steps + TW
        labels = window(u, steps, TW, "labels")
        data, _ = jax_step(pde, mi, pred, labels_prev, labels,
                           process_settings={})

    def loss_fn(p):
        pred, _ = jax_step(pde, mi, apply(p, data, steps), labels, None,
                           get_bc=False, process_settings={})
        return jnp.sqrt(jt.criterion(pred, labels))

    return jax.value_and_grad(loss_fn)(jt.params)


@pytest.mark.parametrize("depth", [0, 2])
def test_train_step_matches_jax(trainers, monkeypatch, depth):
    """Loss and every parameter's gradient at an injected depth; the
    pushforward's no-grad applies take their windows of t_cond. The
    rebuilt JAX loss is first held to the JAX trainer's shipped step
    (rtol 1e-4) at its own start steps, which the port then takes."""
    import nps_tpu.train.pushforward as jax_pushforward
    from nps_tpu.utils.seed import get_seed

    jt, pt, batch, params0 = trainers
    jt.params = jax.tree_util.tree_map(jnp.asarray, params0)
    jt.set_optimizer(dict(object="optim.Adam", lr=1e-4))
    pt.load_jax_params(params0)
    pt._build_optimizer()
    epoch, batch_idx = 25 * depth, 3   # the ramp admits the depth
    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(get_seed()), epoch), batch_idx)
    steps0 = np.array(jax.random.randint(
        key, (B,), TW, NT - TW - TW * depth + 1, dtype=jnp.int32))
    with jax.default_matmul_precision("highest"):
        loss_ref, grads = _jax_loss_and_grads(jt, batch, depth, steps0)
        monkeypatch.setattr(jax_pushforward.py_random, "choice",
                            lambda seq: depth)
        loss_shipped, _ = jt.train_step(tuple(jnp.asarray(a) for a in batch),
                                        epoch, batch_idx, loader=None)
    np.testing.assert_allclose(float(loss_shipped), float(loss_ref),
                               rtol=1e-4)
    loss, _ = pt.train_step(
        tuple(torch.from_numpy(np.asarray(a)) for a in batch), 0, 0,
        unrolled=depth, steps0=torch.from_numpy(steps0))
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=REL_LOSS)
    _assert_grads({k: p.grad.numpy() for k, p in pt.model.named_parameters()},
                  grads)


def test_test_step_and_simulate_match_jax(trainers):
    """test_step's per-step and unrolled losses, and simulate()'s rollout
    with the t_conditioning windows."""
    jt, pt, batch, params0 = trainers
    jt.params = jax.tree_util.tree_map(jnp.asarray, params0)
    pt.load_jax_params(params0)
    with jax.default_matmul_precision("highest"):
        loss_ref, info_ref = jt.test_step(
            tuple(jnp.asarray(a) for a in batch), 0)
    loss, info = pt.test_step(
        tuple(torch.from_numpy(np.asarray(a)) for a in batch), 0)
    assert set(info) == set(info_ref)
    for k, v in info_ref.items():
        np.testing.assert_allclose(info[k], v, rtol=REL_LOSS, atol=1e-12,
                                   err_msg=k)
    np.testing.assert_allclose(loss, loss_ref, rtol=REL_LOSS)
    _, u, x, cond, tc, sc = (np.asarray(a) for a in batch)
    kw = dict(compute_loss=True, include_data=True, nr_gt_steps=1,
              t_res=NT, t_conditioning=tc, spatial_conditioning=sc)
    with jax.default_matmul_precision("highest"):
        losses_ref, (_, pred_ref) = jt.simulate(u, cond, x, **kw)
    losses, (_, pred) = pt.simulate(u, cond, x, **kw)
    np.testing.assert_allclose(losses, losses_ref, rtol=REL_LOSS)
    nrmse = np.sqrt(np.mean((pred - pred_ref) ** 2) / np.mean(pred_ref ** 2))
    assert nrmse < NRMSE


def test_cli_trains_one_epoch_on_cpu(data_dir):
    """One epoch of the time-conditioned config through the port's CLI,
    with --dataset.t_conditioning: finite losses, a metrics line, the
    saved model with its BC encoder."""
    from nps_tpu_torch import train_cli

    argv = ["prog", "-C", PORT_CFG, "--device", "cpu",
            *_argv(data_dir, ["--trainer.num_epochs=1",
                              "--trainer.test_interval=1",
                              "--dataset.t_conditioning=t_conditioning",
                              "--experiment_name=cli"])]
    trainer = train_cli.cli(argv)
    save = trainer.config.save_path
    with open(save + "_metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows] == [0]
    assert np.isfinite(rows[0]["train_loss"])
    assert np.isfinite(rows[0]["default - val loss"])
    state = torch.load(save + "_default.pt", weights_only=True)
    assert "bc_encoder.bc_encoder.5.weight" in state


def test_engine_refuses_a_bc_encoder_as_jax_cannot_serve_it(trainers):
    """The JAX engine applies the model with bc=None, t_cond=None: with the
    trained weights of a time-conditioned model its rollout fails (the
    processors' weights take the BC encoder's channels). The port's engine
    refuses such a model at construction."""
    from nps_tpu.inference import SurrogateEngine as JaxEngine
    from nps_tpu_torch.inference import SurrogateEngine

    jt, pt, batch, params0 = trainers
    jeng = JaxEngine(jt.model, jax.tree_util.tree_map(jnp.asarray, params0),
                     jt.data.pde, TW)
    _, u, x, cond, _, sc = (np.asarray(a) for a in batch)
    with pytest.raises(Exception):
        jeng.rollout(u[:, :, :TW], n_steps=1, cond=cond, spatial_cond=sc)
    with pytest.raises(ValueError, match="BC encoder"):
        SurrogateEngine(pt.model, pt.data.pde, TW, device="cpu")


# ---- the pipeline's BC-encoder stage in a gloo world of two -----------------

def _pp_model():
    """The 1D FNO with a BC encoder of the JAX pipeline test, two blocks
    (one a stage), at the seed's weights."""
    from nps_tpu_torch.models.enc_proc_dec import EncProcDec

    kw, make_pde, _ = _case("1d_bc")
    return EncProcDec(pde=make_pde(False), **dict(_port_kw(kw),
                                                  hidden_blocks=2))


def _pp_inputs():
    rng = np.random.default_rng(5)
    b = 4
    return dict(u=rng.random((b, 2, TW, 32), dtype=np.float32),
                cond=rng.random((b, 1), dtype=np.float32),
                bc=rng.random((b, 2, TW), dtype=np.float32),
                pos=np.broadcast_to(_pde1d(True).x[None], (b, 32)).astype(
                    np.float32))


def _forward_backward(model, inputs, dy):
    out = model(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    (out * torch.from_numpy(dy)).sum().backward()
    return out.detach(), {k: p.grad for k, p in model.named_parameters()}


def _pp_worker(spec_path):
    """One pipe rank of two: the model's forward and backward under the
    pipe axis (two microbatches), each gradient summed as the trainer's
    GradSums sums it (the partial ones over the pipe group)."""
    from nps_tpu_torch import parallel
    from nps_tpu_torch.parallel import init_distributed, pipeline
    from nps_tpu_torch.parallel.mesh import sum_grads_

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    init_distributed(spec["rendezvous"], world_size=2, rank=spec["rank"],
                     device="cpu", timeout=WORKER_TIMEOUT)
    try:
        g = torch.load(spec["inputs"], weights_only=False)
        model = _pp_model()
        model.load_state_dict(g["state"])
        grid = parallel.Grid(2, "pipe")
        pipeline.check(model, 2)
        grid.axis.micro = 2
        with parallel.scope(grid.axis):
            out, _ = _forward_backward(model, g["inputs"], g["dy"])
        partial = {id(p) for p in pipeline.partial_params(model)}
        params = list(model.parameters())
        sums = parallel.GradSums([
            (grid.data_group, grid.data_size,
             [p for p in params if id(p) not in partial], False),
            (None, 2, [p for p in params if id(p) in partial], True)])
        sum_grads_(sums, params)
        torch.save(dict(out=out, grads={k: p.grad for k, p in
                                        model.named_parameters()}),
                   f"{spec['out']}/r{spec['rank']}.pt")
    finally:
        torch.distributed.destroy_process_group()


def test_pipelined_bc_encoder_path(tmp_path):
    """The 1D FNO with a BC encoder pipelined over two ranks (one block a
    stage, two microbatches): the BC encoder runs replicated in the
    encoder's stage. Each rank's output against one process's and JAX's
    forward, and its summed gradients against one process's."""
    import nps_tpu.models as jm
    from test_torch_distributed import _assert_ok, _rendezvous, _run_world
    from nps_tpu_torch.compat.jax_weights import from_jax_params

    kw, make_pde, _ = _case("1d_bc")
    kw = dict(kw, hidden_blocks=2)
    inputs = _pp_inputs()
    jmodel = jm.EncProcDec(pde=make_pde(True), **kw)
    with jax.default_matmul_precision("highest"):
        ref, params = jax.jit(lambda: jmodel.init_with_output(
            jax.random.PRNGKey(5), **inputs))()
    state = from_jax_params(_tree_np(params))
    dy = np.random.default_rng(6).standard_normal(ref.shape).astype(
        np.float32)
    single = _pp_model()
    single.load_state_dict(state)
    out1, grads1 = _forward_backward(single, inputs, dy)
    assert _rel(out1.numpy(), ref) < REL_FWD

    torch.save(dict(state=state, inputs=inputs, dy=dy), tmp_path / "in.pt")
    commands = []
    for rank in range(2):
        spec = tmp_path / f"spec{rank}.json"
        spec.write_text(json.dumps(dict(
            rank=rank, rendezvous=_rendezvous(tmp_path),
            inputs=str(tmp_path / "in.pt"), out=str(tmp_path))))
        commands.append([sys.executable, os.path.abspath(__file__),
                         "--worker", str(spec)])
    _assert_ok(_run_world(commands, WORKER_TIMEOUT))
    for rank in range(2):
        res = torch.load(tmp_path / f"r{rank}.pt", weights_only=False)
        assert _rel(res["out"].numpy(), out1.numpy()) < REL_PP
        assert _rel(res["out"].numpy(), ref) < REL_FWD
        assert set(res["grads"]) == set(grads1)
        floor = 1e-5 * max(float(g.abs().max()) for g in grads1.values())
        for k, g in res["grads"].items():
            scale = max(float(grads1[k].abs().max()), floor)
            assert float((g - grads1[k]).abs().max()) / scale < REL_PP_GRAD, k


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _pp_worker(sys.argv[2])
