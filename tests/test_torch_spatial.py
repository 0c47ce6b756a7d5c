"""Spatial parallelism in the port (``nps_tpu_torch.parallel.spatial``): the
first spatial axis of every field split over the ranks of an x group, in
real gloo worlds on the CPU of K = 2 (two processes) and of D = 2 data
slices x K = 2 (four), held against the port's single-process forward,
train step, evaluation and rollout, and against ``nps_tpu``'s unsharded
forward and ``jax.grad`` on the global batch.

Sizes: the U-FNO twophase config at 2 blocks x 16 features, 4 modes, a
16 x 16 grid (8 local rows at K = 2, 4 at the U-Net's second level), time
window 5, 21 frames, a global batch of 4; the ns512 config at 1 block x 8
features on a 32 x 32 split, batch 2, in bf16 with remat. The workers are
this file run as a script (``python tests/test_torch_spatial.py --worker
SPEC``), one thread each, with the harness of ``test_torch_distributed.py``.

Bars: against the port's single process, the forward and the frames max|d|
/ max|ref| <= 1e-5, the loss and every evaluation value rtol 1e-5, every
gradient 1e-4 of max(its own max |ref|, 1e-3 of the largest) (the split
sums each cell's products in another order); against JAX, the forward
1e-4 and the ROADMAP bars (loss rtol 2e-3, gradients 5e-3 above a floor of
1e-5 of the largest); the split stages' plain versions against the whole
plane 1e-6; the halo and the building blocks against their local
references 1e-6; bf16 against the port's single-process bf16 step 8e-3,
the floor of ``test_torch_ns512.py``'s bf16 bar (loss, and each gradient in
RMS terms).
"""

import json
import math
import os
import sys
from argparse import Namespace

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_distributed import (  # noqa: E402
    JAX_CFG, NT, PORT_CFG, TW, _assert_grads_close, _assert_ok, _rendezvous,
    _grads, _overrides, _parse, _rel, _run_world, _tensors, port_trainer)

NS_CFG = "nps_tpu_torch/configs/train/cfg_ns512_ufno.py"
NX, B, K = 16, 4, 2
REL_FWD, REL_SP, REL_SP_GRAD = 1e-5, 1e-5, 1e-4
REL_JAX_FWD, REL_LOSS, REL_GRAD = 1e-4, 2e-3, 5e-3
REL_PLAIN, BF16_BAR = 1e-6, 8e-3
NS_N, NS_B = 32, 2
NS_OVERRIDES = ["--model.hidden_features=8", "--model.hidden_blocks=1",
                "--model.fno_modes=4", f"--time_window={TW}",
                f"--base_resolution=[{NT},{NS_N},{NS_N}]",
                f"--super_resolution=[{NT},{NS_N},{NS_N}]",
                f"--batch_size={NS_B}"]
# the other grid families, each at a grid its U-Net's valid convs take
FAMILIES = {
    "ufno": ("cfg_twophase_ufno.py", 16, ["--model.hidden_features=16",
                                           "--model.hidden_blocks=2",
                                           "--model.fno_modes=4"]),
    "unet": ("cfg_twophase_unet.py", 64, ["--model.hidden_features=8"]),
    "drn": ("cfg_twophase_drn.py", 16, ["--model.hidden_features=16",
                                         "--model.hidden_blocks=2"]),
    "ufno_fno": ("cfg_twophase_ufno_fno.py", 16, [
        "--model.hidden_features=16", "--model.fno_modes=4"]),
}
WORKER_TIMEOUT = 300


def _ufnos(model):
    from nps_tpu_torch.models.ufno import UFNO

    return [m for m in model.modules() if isinstance(m, UFNO)]


def _set_remat(model, on):
    for m in _ufnos(model):
        m.remat = on


def _engine(cfg, n, overrides, weights=None):
    """A port engine on the CPU for a twophase family at an n x n grid."""
    from nps_tpu_torch.inference import SurrogateEngine
    from nps_tpu_torch.pde import PDE2D

    pde = PDE2D(tmin=0, tmax=1, nt=NT, L1=1.0, L2=1.0, nx1=n, nx2=n, x=None,
                name="twophase", n_cond_static=2, n_cond_spatial=2)
    eng = SurrogateEngine.from_config(
        f"nps_tpu_torch/configs/train/{cfg}", pde=pde, device="cpu",
        overrides=[f"--base_resolution=[{NT},{n},{n}]",
                   f"--super_resolution=[{NT},{n},{n}]",
                   f"--time_window={TW}", *overrides])
    if weights is None:
        eng.init_params(seed=0)
    else:
        eng.load(weights)
    return eng


def _rollout_inputs(n, b=B):
    rng = np.random.default_rng(11)
    u0 = rng.standard_normal((b, 1, TW, n, n)).astype(np.float32)
    cond = rng.standard_normal((b, 2)).astype(np.float32)
    sc = (rng.random((b, 2, n, n)) > 0.8).astype(np.float32)
    return u0, cond, sc


# ---------------------------------------------------------------- workers
def _sp_trainer(spec, cfg=PORT_CFG, argv=None):
    """The port's trainer, split over the grid of the spec's world."""
    from nps_tpu_torch import train_cli
    from nps_tpu_torch.configs.parse import parse_args

    flags = ["--trainer.data_parallel=true",
             f"--trainer.spatial_parallel={spec['k']}"]
    if argv is None:
        tr = port_trainer(spec["data"], spec["out"], flags)
        tr.load_model(spec["weights"])
    else:
        tr = train_cli.get_config_static(
            _parse(parse_args, cfg, [*argv, *flags]), device="cpu")[4]
        tr.init_params(seed=0)
        tr.set_optimizer(dict(object="optim.Adam", lr=1e-4))
    tr.ensure_initialized()
    return tr


def _mine(tr, batch, steps0):
    """This rank's data slice of the global batch, at its rows, and its
    start steps."""
    b = len(batch[0]) // tr.world
    part = slice(tr.rank * b, (tr.rank + 1) * b)
    return (tr.grid.shard_batch(tuple(t[part] for t in _tensors(batch))),
            steps0[part])


def _step(tr, batch, steps0, unrolled):
    mine, starts = _mine(tr, batch, steps0)
    loss, _ = tr.train_step(mine, 0, 0, unrolled=unrolled, steps0=starts)
    return dict(loss=float(loss), grads=_grads(tr))


def sc_forward(spec, g):
    tr = _sp_trainer(spec)
    mine, _ = _mine(tr, g["batch"], g["steps0"])
    with torch.no_grad():
        pred = tr._apply(mine[1][:, :, :TW], mine[3], None, mine[2], None,
                         mine[5])
    return tr.grid.gather_frames(pred)


def sc_steps(spec, g):
    out = {}
    for remat in (False, True):
        tr = _sp_trainer(spec)
        _set_remat(tr.model, remat)
        out[remat] = _step(tr, g["batch"], g["steps0"], 1)
    return out


def sc_trap(spec, g):
    """The step with the model's partial sums taken by an all-reduce whose
    backward passes the gradient through (as the loss's global_sum does)."""
    from nps_tpu_torch.parallel import spatial

    class IdentityBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, axis):
            return spatial.sum_(x.contiguous().clone(), axis)

        @staticmethod
        def backward(ctx, grad):
            return grad, None

    saved = spatial.spatial_sum
    spatial.spatial_sum = lambda x, axis=None: IdentityBackward.apply(
        x, axis or spatial.current())
    try:
        return _step(_sp_trainer(spec), g["batch"], g["steps0"], 1)
    finally:
        spatial.spatial_sum = saved


def sc_eval(spec, g):
    tr = _sp_trainer(spec)
    loss, stats, (frames, other) = tr.test(tr.get_dataloaders()[1],
                                           include_data=True)
    return dict(loss=loss, stats=stats, frames=frames, n=len(other))


def sc_engine(spec, g):
    """The U-FNO's shard(K) rollout and captured=True's refusal; then every
    rank shards a shard(K) and a shard(0) engine, and exports one of them
    alone (even ranks the first, odd ranks the second), loads the artifact
    and rolls it out in this process (the collectives the export made
    counted)."""
    from nps_tpu_torch.inference import load_exported
    from nps_tpu_torch.parallel import spatial

    u0, cond, sc = _rollout_inputs(NX)
    engines = {k: _engine(*FAMILIES["ufno"], weights=spec["weights"]).shard(k)
               for k in (spec["k"], 0)}
    eng = engines[spec["k"]]
    out = dict(frames=eng.rollout(u0, 3, cond=cond, spatial_cond=sc))
    try:
        eng.rollout(u0, 3, cond=cond, spatial_cond=sc, captured=True)
        out["captured"] = None
    except NotImplementedError as e:
        out["captured"] = str(e)
    k = (spec["k"], 0)[spec["rank"] % 2]
    path = os.path.join(spec["out"], f"x{spec['rank']}.npst")
    spatial.traffic.clear()
    engines[k].export_rollout(path, 3, u0, cond=cond, spatial_cond=sc)
    out["export"] = dict(shard=k, traffic=dict(spatial.traffic),
                         frames=load_exported(path).rollout(
                             u0, cond=cond, spatial_cond=sc))
    return out


def sc_bf16(spec, g):
    tr = _sp_trainer(spec, NS_CFG, [*NS_OVERRIDES,
                                    f"--dataset.base_path={spec['ns']}",
                                    f"--experiment_path={spec['out']}"])
    assert tr.compute_dtype == torch.bfloat16
    return _step(tr, g["ns_batch"], g["ns_steps0"], 0)


def sc_families(spec, g):
    """Each grid family's split forward against its unsplit forward in this
    process (the same weights from the seed): max|d| / max|ref|."""
    from nps_tpu_torch import parallel
    from nps_tpu_torch.parallel import spatial

    grid = parallel.Grid(spec["k"])
    errs = {}
    for name, (cfg, n, ov) in FAMILIES.items():
        eng = _engine(cfg, n, ov)
        u0, cond, sc = (torch.from_numpy(a) for a in _rollout_inputs(n, 2))
        pos = eng._pos(2)
        with torch.no_grad():
            ref = eng.model(u0, cond=cond, pos=pos, spatial_cond=sc)
            _, u, p, _, _, s = grid.shard_batch((u0, u0, pos, cond, None, sc))
            with spatial.scope(grid.axis.at(n)):
                got = eng.model(u, cond=cond, pos=p, spatial_cond=s)
        got = grid.gather_frames(got)
        errs[name] = float((got - ref).abs().max() / ref.abs().max())
    return errs


def sc_blocks(spec, g):
    """The building blocks against their local references in this process:
    the halo (and its gradient), the sharded circular conv at halos 1 and 2,
    the sharded row DFT, a stride-2 conv at an odd local row offset, the
    transposed conv and the crop at both global edges. Errors max|d| /
    max|ref|."""
    import torch.nn.functional as F

    from nps_tpu_torch import parallel
    from nps_tpu_torch.models.common import ConvND, ConvTransposeND, crop_nd
    from nps_tpu_torch.ops.spectral import _dft_mats_fwd_rows
    from nps_tpu_torch.parallel import spatial

    grid = parallel.Grid(spec["k"])
    axis = grid.axis
    rng = np.random.default_rng(3)
    errs = {}

    def rel(a, ref):
        return float((a - ref).abs().max() / ref.abs().max())

    def rows(t, n, dim=2):
        lo, hi = axis.part(n)
        return t.narrow(dim, lo, hi - lo)

    x = torch.from_numpy(rng.standard_normal((2, 3, 32, 12),
                                             dtype=np.float32))
    for halo in (1, 2):
        xl = rows(x, 32).clone().requires_grad_(True)
        y = spatial.halo_exchange(xl, halo, axis)
        xf = x.clone().requires_grad_(True)
        ref = F.pad(xf, (0, 0, halo, halo), mode="circular")
        lo, hi = axis.part(32)
        w = torch.from_numpy(rng.standard_normal(ref.shape,
                                                 dtype=np.float32))
        (y * w[:, :, lo:hi + 2 * halo]).sum().backward()
        # every rank's loss, on the unsharded pad: the windows overlap
        sum((ref * w)[:, :, a:b + 2 * halo].sum() for a, b in
            (axis.part(32, q) for q in range(axis.size))).backward()
        errs[f"halo{halo}"] = rel(y.detach(), ref[:, :, lo:hi + 2 * halo])
        # the gradient of each rank's rows (its own and its neighbours'
        # halo gradients), gathered over the ranks
        gsum = spatial.sum_(torch.zeros_like(x).index_copy(
            2, torch.arange(lo, hi), xl.grad), axis)
        errs[f"halo{halo}_grad"] = rel(gsum, xf.grad)
    wk = torch.from_numpy(rng.standard_normal((4, 3, 3, 3),
                                              dtype=np.float32)) * 0.3
    ref = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="circular"), wk)
    errs["conv_halo1"] = rel(spatial.sharded_conv2d_same_circular(
        rows(x, 32), wk, axis), rows(ref, 32))
    dil = ConvND(3, 4, 3, 2, padding="same", padding_mode="circular",
                 dilation=2)
    with torch.no_grad():
        ref = dil(x)
        with spatial.scope(axis.at(32)):
            errs["conv_halo2"] = rel(dil(rows(x, 32)), rows(ref, 32))
    xr = torch.from_numpy(rng.standard_normal((2, 32, 5, 3),
                                              dtype=np.float32))
    c1, s1 = (torch.from_numpy(a) for a in _dft_mats_fwd_rows(32, 4))
    re, im = spatial.sharded_spectral_rows_transform(
        rows(xr, 32, 1), rows(c1, 32, 0), rows(s1, 32, 0), axis)
    errs["rows_dft"] = max(
        rel(re, torch.einsum("bxmc,xk->bkmc", xr, c1)),
        rel(im, -torch.einsum("bxmc,xk->bkmc", xr, s1)))
    # 14 rows: rank 1's rows start at 7, an odd offset for a stride-2 conv
    x14 = x[:, :, :14]
    down = ConvND(3, 4, 3, 2, strides=2, padding="valid")
    up = ConvTransposeND(3, 4, 4, 2, strides=2, pre_pad=1)
    with torch.no_grad():
        for name, fn, n_out in (("stride2_odd", down, down.out_rows(14)),
                                ("transposed", up, up.out_rows(14))):
            ref = fn(x14)
            with spatial.scope(axis.at(14)):
                got = fn(rows(x14, 14))
            errs[name] = rel(got, rows(ref, n_out))
        for name, n_out in (("crop", 10), ("pad", 19)):
            ref = crop_nd(x14, (n_out, 12), 2)
            with spatial.scope(axis.at(14)):
                got = crop_nd(rows(x14, 14), (n_out, 12), 2, 14, n_out)
            errs[name] = rel(got, rows(ref, n_out))
    return errs


SCENARIOS = dict(forward=sc_forward, steps=sc_steps, trap=sc_trap,
                 eval=sc_eval, engine=sc_engine, bf16=sc_bf16,
                 families=sc_families, blocks=sc_blocks)


def _worker(spec_path):
    from nps_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    init_distributed(spec["rendezvous"], world_size=spec["world"],
                     rank=spec["rank"], device="cpu", timeout=WORKER_TIMEOUT)
    try:
        g = torch.load(spec["inputs"], weights_only=False)
        res = {name: SCENARIOS[name](spec, g) for name in spec["scenarios"]}
        torch.save(res, f"{spec['out']}/r{spec['rank']}.pt")
    finally:
        torch.distributed.destroy_process_group()


# ------------------------------------------------------------ fixtures
@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    from nps_tpu_torch.data.synthetic import generate

    root = tmp_path_factory.mktemp("spatial")
    # 20 simulations: splits of 16/2/2
    generate(str(root / "data" / "twophase"), n_sims=20, n_channels=1,
             nt=NT, nx1=NX, nx2=NX, seed=3)
    generate(str(root / "ns" / "ns512"), n_sims=4, n_channels=1, nt=NT,
             nx1=NS_N, nx2=NS_N, seed=4)
    return root


def _port_ns512(root, out):
    from nps_tpu_torch import train_cli
    from nps_tpu_torch.configs.parse import parse_args

    tr = train_cli.get_config_static(_parse(parse_args, NS_CFG, [
        *NS_OVERRIDES, f"--dataset.base_path={root / 'ns'}",
        f"--experiment_path={out}"]), device="cpu")[4]
    tr.init_params(seed=0)
    tr.set_optimizer(dict(object="optim.Adam", lr=1e-4))
    tr.ensure_initialized()
    return tr


@pytest.fixture(scope="module")
def reference(data_dir):
    """JAX's trainer and weights, one global batch and start steps, and the
    port's single-process forward, steps (remat off and on), evaluation,
    rollout and bf16 ns512 step from the same weights and inputs."""
    import jax

    from nps_tpu.configs.parse import parse_args as jax_parse_args
    from nps_tpu.data.pipeline import HostDataLoader as JaxHostDataLoader
    from nps_tpu.train_cli import get_config_static as jax_build
    from nps_tpu_torch.data.pipeline import HostDataLoader

    out = data_dir / "ref"
    jt = jax_build(_parse(jax_parse_args, JAX_CFG,
                          _overrides(data_dir / "data", out)))[5]
    batch = next(iter(JaxHostDataLoader(jt.data.train, B, seed=0,
                                        process_index=0, process_count=1)))
    with jax.default_matmul_precision("highest"):
        jt.init_params(batch)
    params0 = jax.tree_util.tree_map(np.asarray, jt.params)
    steps0 = torch.from_numpy(np.random.default_rng(5).integers(
        TW, NT - 3 * TW + 1, B))

    pt = port_trainer(data_dir / "data", out)
    pt.load_jax_params(params0)
    pt.ensure_initialized()
    weights = data_dir / "weights.pt"
    torch.save(pt.model.state_dict(), weights)
    single = {}
    t = _tensors(batch)
    with torch.no_grad():
        single["forward"] = pt._apply(t[1][:, :, :TW], t[3], None, t[2],
                                      None, t[5])
    single["steps"] = {}
    for remat in (False, True):
        pt = port_trainer(data_dir / "data", out)
        pt.load_model(str(weights))
        pt.ensure_initialized()
        _set_remat(pt.model, remat)
        loss, _ = pt.train_step(t, 0, 0, unrolled=1, steps0=steps0)
        single["steps"][remat] = dict(loss=float(loss), grads=_grads(pt))
    pt = port_trainer(data_dir / "data", out)
    pt.load_model(str(weights))
    loss, stats, (frames, other) = pt.test(pt.get_dataloaders()[1],
                                           include_data=True)
    single["eval"] = dict(loss=loss, stats=stats, frames=frames,
                          n=len(other))
    eng = _engine(*FAMILIES["ufno"], weights=str(weights))
    u0, cond, sc = _rollout_inputs(NX)
    single["rollout"] = eng.rollout(u0, 3, cond=cond, spatial_cond=sc)

    ns = _port_ns512(data_dir, out)
    ns_batch = next(iter(HostDataLoader(ns.data.train, NS_B, seed=0)))
    ns_steps0 = torch.tensor([TW, TW + 3])
    loss, _ = ns.train_step(_tensors(ns_batch), 0, 0, unrolled=0,
                            steps0=ns_steps0)
    single["bf16"] = dict(loss=float(loss), grads=_grads(ns))
    inputs = data_dir / "inputs.pt"
    torch.save(dict(batch=batch, steps0=steps0, ns_batch=ns_batch,
                    ns_steps0=ns_steps0), inputs)
    return dict(jt=jt, params0=params0, batch=batch, steps0=steps0,
                single=single, inputs=inputs, weights=weights)


def _world(data_dir, reference, n, scenarios):
    out = data_dir / f"world{n}"
    out.mkdir()
    rendezvous = _rendezvous(out)
    commands = []
    for rank in range(n):
        spec = out / f"spec{rank}.json"
        spec.write_text(json.dumps(dict(
            rank=rank, world=n, k=K, rendezvous=rendezvous,
            data=str(data_dir / "data"),
            ns=str(data_dir / "ns"), out=str(out),
            inputs=str(reference["inputs"]),
            weights=str(reference["weights"]), scenarios=scenarios)))
        commands.append([sys.executable, os.path.abspath(__file__),
                         "--worker", str(spec)])
    _assert_ok(_run_world(commands, WORKER_TIMEOUT))
    return [torch.load(out / f"r{r}.pt", weights_only=False)
            for r in range(n)]


@pytest.fixture(scope="module")
def worlds(data_dir, reference):
    """The ranks' results: K = 2 in a world of two (every scenario), and
    D = 2 x K = 2 in a world of four."""
    return {2: _world(data_dir, reference, 2, list(SCENARIOS)),
            4: _world(data_dir, reference, 4,
                      ["forward", "steps", "eval", "engine"])}


# ------------------------------------------------------------------ tests
def test_split_stages_plain_match_the_whole_plane():
    """In one process, K = 2 slices of the rows summed by hand: the split K1
    (stage A, the sum, stage B) and the split K2 (sums, the sum, apply) in
    their plain versions equal the whole-plane plain versions, forward and
    every gradient, with FiLM, and with both GELU forms."""
    from nps_tpu_torch.ops import group_norm as gn
    from nps_tpu_torch.ops import spectral as sp

    rng = np.random.default_rng(0)

    def leaf(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32)
                            * scale, requires_grad=True)

    n1, n2, modes, cuts = 16, 12, (4, 3), (0, 7, 16)
    x = leaf(3, 5, n1, n2)
    w = [leaf(2, 5, 6, 4, 3, scale=0.2), leaf(2, 5, 6, 4, 3, scale=0.2)]
    film = leaf(3, 6, 8, 3, scale=0.5)
    ref = sp.spectral_conv_2d_plain(x, w, modes, film, 0)
    spectra = [sp._spectrum_plain(x[:, :, lo:hi], modes, (n1, lo))
               for lo, hi in zip(cuts, cuts[1:])]
    re = spectra[0][0] + spectra[1][0]
    im = spectra[0][1] + spectra[1][1]
    y_re, y_im = sp._mix_plain(re, im, w, modes, film, 0)
    got = torch.cat([sp._inverse_plain(y_re, y_im, (hi - lo, n2), modes,
                                       (n1, lo))
                     for lo, hi in zip(cuts, cuts[1:])], dim=2)
    cot = torch.from_numpy(rng.standard_normal(ref.shape, dtype=np.float32))
    leaves = [x, *w, film]
    g_ref = torch.autograd.grad((ref * cot).sum(), leaves)
    g_got = torch.autograd.grad((got * cot).sum(), leaves)
    assert _rel(got.detach(), ref.detach()) <= REL_PLAIN
    for a, b in zip(g_got, g_ref):
        assert _rel(a, b) <= REL_PLAIN

    for approximate in ("none", "tanh"):
        xg, wg, bg = leaf(3, 5, n1, n2), leaf(5), leaf(5)
        ref = gn.gn_gelu_plain(xg, wg, bg, approximate=approximate)
        sums = sum(gn.gn_split_sums_plain(xg[:, :, lo:hi])
                   for lo, hi in zip(cuts, cuts[1:]))
        got = torch.cat([gn.gn_split_apply_plain(
            xg[:, :, lo:hi], sums, 5 * n1 * n2, wg, bg,
            approximate=approximate) for lo, hi in zip(cuts, cuts[1:])], 2)
        cot = torch.from_numpy(rng.standard_normal(ref.shape,
                                                   dtype=np.float32))
        g_ref = torch.autograd.grad((ref * cot).sum(), (xg, wg, bg))
        g_got = torch.autograd.grad((got * cot).sum(), (xg, wg, bg))
        assert _rel(got.detach(), ref.detach()) <= REL_PLAIN
        for a, b in zip(g_got, g_ref):
            assert _rel(a, b) <= REL_PLAIN


def test_building_blocks_match_local_references(worlds):
    """The halo (its values and the gradient it returns to the neighbours'
    edge rows), the sharded circular conv at halos 1 and 2 (dilation 2),
    the sharded row DFT, and the split forms of a stride-2 conv at an odd
    local row offset (7 of 14 rows: its output rows take the input rows
    they read from the neighbour), of the transposed conv and of the crop
    and the pad at both global edges, against their local references."""
    for res in worlds[2]:
        errs = res["blocks"]
        assert set(errs) == {"halo1", "halo1_grad", "halo2", "halo2_grad",
                             "conv_halo1", "conv_halo2", "rows_dft",
                             "stride2_odd", "transposed", "crop", "pad"}
        for name, err in errs.items():
            assert err <= REL_PLAIN, (name, err)


@pytest.mark.parametrize("n", [2, 4])
def test_forward_matches_single_process_and_jax(reference, worlds, n):
    """The split forward (gathered in global order) equals the port's
    single-process forward and nps_tpu's unsharded forward."""
    import jax
    import jax.numpy as jnp

    jt, batch = reference["jt"], reference["batch"]
    u, x, cond, sc = (jnp.asarray(batch[i]) for i in (1, 2, 3, 5))
    with jax.default_matmul_precision("highest"):
        jref = np.asarray(jax.jit(lambda p: jt.model.apply(
            p, u[:, :, :TW], cond=cond, bc=None, pos=x, t_cond=None,
            spatial_cond=sc))(jax.tree_util.tree_map(
                jnp.asarray, reference["params0"])))
    ref = reference["single"]["forward"]
    for res in worlds[n]:
        got = res["forward"]
        assert got.shape == ref.shape
        assert _rel(got, ref) <= REL_FWD
        assert _rel(got, jref) <= REL_JAX_FWD


@pytest.mark.parametrize("n,remat", [(2, False), (2, True), (4, False),
                                     (4, True)])
def test_step_matches_single_process(reference, worlds, n, remat):
    """The split step at depth 1 (remat off, and on: the recompute makes
    the forward's halos and sums again): loss and every gradient equal the
    single-process step's, on every rank."""
    ref = reference["single"]["steps"][remat]
    for res in worlds[n]:
        got = res["steps"][remat]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=REL_SP)
        _assert_grads_close(got["grads"], ref["grads"], REL_SP_GRAD, 1e-3)


@pytest.mark.parametrize("n", [2, 4])
def test_step_matches_jax(reference, worlds, n):
    """The split step's loss and gradients against jax.grad of the JAX loss
    on the global batch, same weights and starts."""
    import jax
    import jax.numpy as jnp

    from nps_tpu.train.pushforward import window
    from nps_tpu.utils.process_output import process_step
    from nps_tpu_torch.compat.jax_weights import from_jax_params

    jt, batch = reference["jt"], reference["batch"]
    _, u, x, cond, _, sc = (jnp.asarray(a) for a in batch)
    pde, mi = jt.data.pde, jt.model.model_interface
    apply = jax.jit(lambda p, d: jt.model.apply(
        p, d, cond=cond, bc=None, pos=x, t_cond=None, spatial_cond=sc))

    def loss_fn(p, data, labels):
        pred, _ = process_step(pde, mi, apply(p, data), labels, None,
                               get_bc=False, process_settings={})
        return jnp.sqrt(jt.criterion(pred, labels))

    params = jax.tree_util.tree_map(jnp.asarray, reference["params0"])
    with jax.default_matmul_precision("highest"):
        steps = jnp.asarray(reference["steps0"].numpy())
        data, labels = window(u, steps, TW, "both")
        pred = apply(params, data)
        labels_prev, steps = labels, steps + TW
        labels = window(u, steps, TW, "labels")
        data, _ = process_step(pde, mi, pred, labels_prev, labels,
                               process_settings={})
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, data,
                                                           labels)
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, grads))
    for res in worlds[n]:
        got = res["steps"][False]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=REL_LOSS)
        _assert_grads_close(got["grads"], ref, REL_GRAD, 1e-5)


def test_identity_backward_sum_fails_the_gradient_check(reference, worlds):
    """The trap: with the model's partial sums (the spectrum, the norm
    statistics, the volume totals) taken by an all-reduce whose backward
    passes the gradient through, each rank keeps only its own share of the
    gradient behind each sum, and the step's gradients miss the
    single-process ones far beyond the bar; the true split's spectral
    weight gradients are the single process's, not K times them."""
    ref = reference["single"]["steps"][False]["grads"]
    for res in worlds[2]:
        with pytest.raises(AssertionError):
            _assert_grads_close(res["trap"]["grads"], ref, REL_SP_GRAD, 1e-3)
        got = res["steps"][False]["grads"]
        for k in ref:
            if k.endswith(("weights1", "weights2")):
                ratio = float(got[k].norm() / ref[k].norm())
                assert abs(ratio - 1) < 1e-4, (k, ratio)


@pytest.mark.parametrize("n", [2, 4])
def test_evaluation_matches_single_process(reference, worlds, n):
    """The split evaluation: the validation loss, every per-step loss and
    metric, and the frames gathered in global order (rows within the x
    group, then the data slices) equal the single process's."""
    ref = reference["single"]["eval"]
    for res in worlds[n]:
        got = res["eval"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=REL_SP)
        assert set(got["stats"]) == set(ref["stats"])
        for k, v in ref["stats"].items():
            np.testing.assert_allclose(got["stats"][k], v, rtol=REL_SP,
                                       err_msg=k)
        assert got["frames"].shape == ref["frames"].shape
        assert got["n"] == ref["n"]
        assert _rel(got["frames"], ref["frames"]) <= REL_FWD


@pytest.mark.parametrize("n", [2, 4])
def test_engine_shard_matches_single_device(reference, worlds, n):
    """``SurrogateEngine.shard(2)``: the rollout's frames equal the
    single-device rollout's on every rank; ``captured=True`` raises on a
    sharded engine, naming ROADMAP §2; ``export_rollout`` of the shard(2)
    engine (even ranks) or of the shard(0) one (odd ranks), called by each
    rank alone, makes no collective and writes an artifact whose rollout
    in one process equals the single-device rollout (rtol 1e-5, atol 1e-6:
    the artifact bar of ``test_torch_export.py``)."""
    ref = reference["single"]["rollout"]
    for res in worlds[n]:
        got = res["engine"]
        assert got["frames"].shape == ref.shape
        assert _rel(got["frames"], ref) <= REL_FWD
        assert got["captured"] is not None and "ROADMAP §2" in got[
            "captured"]
        assert got["export"]["traffic"] == {}
        np.testing.assert_allclose(got["export"]["frames"], ref, rtol=1e-5,
                                   atol=1e-6)
    assert [r["engine"]["export"]["shard"] for r in worlds[n]] == [
        (K, 0)[r % 2] for r in range(n)]


def test_bf16_ns512_step_matches_single_process(reference, worlds):
    """A cfg_ns512_ufno-shaped model (bf16, remat save_conv_outputs, two
    U-Net levels: 32 -> 15 -> 7 rows) at K = 2 against the port's
    single-process bf16 step: the loss, and each gradient in RMS terms
    relative to its own RMS (or 1e-3 of the largest)."""
    ref = reference["single"]["bf16"]

    def rms(t):
        return float(t.double().pow(2).mean().sqrt())

    floor = 1e-3 * max(rms(g) for g in ref["grads"].values())
    for res in worlds[2]:
        got = res["bf16"]
        assert math.isfinite(got["loss"])
        assert abs(got["loss"] - ref["loss"]) / abs(ref["loss"]) <= BF16_BAR
        assert set(got["grads"]) == set(ref["grads"])
        for k, g in ref["grads"].items():
            err = rms(got["grads"][k] - g) / max(rms(g), floor)
            assert err <= BF16_BAR, (k, err)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_grid_families_split_forward(worlds, family):
    """Every grid family that runs split (the U-FNO, the U-Net, the DRN
    and the FNO -> U-FNO chain) gives its unsplit forward at K = 2."""
    for res in worlds[2]:
        assert res["families"][family] <= REL_FWD


def test_refusals():
    """Rows that do not split over K * 2^levels raise; K with tensor,
    pipeline or expert parallelism raises naming their P9b items; spatial
    parallelism without data parallelism or without a process group
    raises; the MP-GNN, the mixture of spectral experts and a 1D model are
    taken (the MP-GNN and the 1D model whole on each x rank, at any rows);
    the 3D FNO and MoE are taken and split their rows; the MP-GNN's
    sharded engine is refused, as JAX's."""
    from nps_tpu_torch.parallel import spatial, validate_grid_layout
    from nps_tpu_torch.train.base import refuse_unported
    from test_torch_conditioning import _grid_model

    ufno = _engine(*FAMILIES["ufno"])
    with pytest.raises(ValueError, match="rows % 4"):
        spatial.check_model(ufno.model, 18, 2)
    spatial.check_model(ufno.model, 16, 2)
    assert spatial.whole(ufno.model) is None
    ufno.model.num_spatial_dims = 1   # a 1D model of the same family
    spatial.check_model(ufno.model, 18, 2)
    assert spatial.whole(ufno.model) == "a 1D model"
    assert spatial.partial_params(ufno.model) == []
    with pytest.raises(ValueError, match="divide the world"):
        validate_grid_layout(3, 2)
    for key, item in (("tensor_parallel", 4), ("pipeline_parallel", 5),
                      ("expert_parallel", 6)):
        cfg = Namespace(data_parallel=True, spatial_parallel=2, **{key: 2})
        with pytest.raises(NotImplementedError, match=f"P9b item {item}"):
            refuse_unported(cfg)
    with pytest.raises(ValueError, match="data_parallel"):
        refuse_unported(Namespace(spatial_parallel=2))
    with pytest.raises(RuntimeError, match="init_distributed"):
        refuse_unported(Namespace(spatial_parallel=2, data_parallel=True))
    for cfg, ov in (("cfg_twophase_gnn.py", ["--model.hidden_features=16",
                                             "--model.hidden_blocks=2"]),
                    ("cfg_twophase_moe.py", ["--model.hidden_features=16",
                                             "--model.hidden_blocks=2",
                                             "--model.fno_modes=4"])):
        eng = _engine(cfg, NX, ov)
        spatial.check_model(eng.model, NX, 2)
        if "gnn" in cfg:
            assert spatial.whole(eng.model) == "the MP-GNN (a graph)"
            with pytest.raises(NotImplementedError, match="JAX engine"):
                eng.shard(2)
        else:
            assert spatial.whole(eng.model) is None
    for piece in ("3d", "moe3d"):
        model = _grid_model(piece)
        spatial.check_model(model, 8, 2)
        assert spatial.whole(model) is None


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(sys.argv[2])
