"""The port's serving artifact and the kernels' custom ops, on the CPU.

- ``nps_torch::gn1_gelu_fwd`` and ``nps_torch::spectral_dft2d_fwd``: their
  CPU implementations equal the plain versions, and
  ``torch.library.opcheck`` passes on them (schema, fake implementation,
  dispatch).
- ``SurrogateEngine.export_rollout`` / ``load_exported`` on the U-FNO
  twophase config at a small size (2 blocks x 16 features, 4 modes, 24x16
  grid, time window 5; the U-FNO's valid-conv U-Net needs more than a 12x8
  grid): the reloaded artifact equals the engine's rollout (rtol 1e-5,
  atol 1e-6, as ``tests/test_inference.py`` holds the JAX artifact), serves
  a batch not seen at export, keeps ``include_init``, raises on missing or
  unexpected conditioning, a bad magic number and another device; its graph
  holds both custom ops and only ATen and ``nps_torch`` ops, and it serves
  in a process that imported nothing of the port but the op registrations.
  Against ``nps_tpu``'s engine on the same weights: rollout nRMSE < 1e-3.
- The export CLI, and ``captured=True`` refused on the CPU.

PyTorch runs on two threads, since the suite's workers share the cores.
"""

import io
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nps_tpu.inference import SurrogateEngine as JaxEngine
from nps_tpu.pde import PDE2D as JaxPDE2D
from nps_tpu_torch.inference import (ARTIFACT_MAGIC, SurrogateEngine,
                                     load_exported)
from nps_tpu_torch.ops import group_norm as gn
from nps_tpu_torch.ops import spectral as sp
from nps_tpu_torch.pde import PDE2D

ROOT = Path(__file__).resolve().parents[1]
NT, NX1, NX2, TW, B, N_STEPS = 21, 24, 16, 5, 2, 2
NRMSE = 1e-3
OVERRIDES = [f"--time_window={TW}", "--model.hidden_features=16",
             "--model.hidden_blocks=2", "--model.fno_modes=4"]
PDE_KW = dict(tmin=0, tmax=10, nt=NT, L1=1.0, L2=0.7, nx1=NX1, nx2=NX2,
              x=None, name="twophase", n_cond_static=2, n_cond_spatial=2)
CFG = "cfg_twophase_ufno.py"


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _inputs(b=B, seed=0):
    rng = np.random.default_rng(seed)
    u0 = (0.1 + 0.8 * rng.random((b, 1, TW, NX1, NX2))).astype(np.float32)
    cond = rng.random((b, 2)).astype(np.float32)
    sc = (rng.random((b, 2, NX1, NX2)) > 0.8).astype(np.float32)
    return u0, cond, sc


@pytest.fixture(scope="module")
def engine():
    eng = SurrogateEngine.from_config(
        f"nps_tpu_torch/configs/train/{CFG}", pde=PDE2D(**PDE_KW),
        overrides=OVERRIDES, device="cpu")
    eng.init_params(seed=3)
    return eng


@pytest.fixture(scope="module")
def artifact(engine, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("export") / "surrogate.npst")
    u0, cond, sc = _inputs()
    engine.export_rollout(path, N_STEPS, u0, cond=cond, spatial_cond=sc)
    return path


# ---- the custom ops -------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gelu", [True, False])
def test_gn_op_cpu_equals_plain_and_passes_opcheck(dtype, gelu):
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(2, 6, 5, 7, generator=g) * 1.5 + 0.3).to(dtype)
    w, b = torch.randn(6, generator=g), torch.randn(6, generator=g)
    y = torch.ops.nps_torch.gn1_gelu_fwd(x, w, b, gelu, gn.EPS)
    assert y.dtype == dtype
    torch.testing.assert_close(y, gn.gn_gelu_plain(x, w, b, gelu), rtol=0,
                               atol=0)
    torch.library.opcheck(torch.ops.nps_torch.gn1_gelu_fwd.default,
                          (x, w, b, gelu, gn.EPS))


@pytest.mark.parametrize("film_mode", [None, 0, 1])
def test_spectral_op_cpu_equals_plain_and_passes_opcheck(film_mode):
    g = torch.Generator().manual_seed(1)
    b, ci, co, modes = 2, 5, 3, (3, 4)
    x = torch.randn(b, ci, 12, 10, generator=g)
    ws = [torch.rand((2, ci, co, *modes), generator=g) / (ci * co)
          for _ in range(2)]
    film = (None if film_mode is None
            else torch.randn(b, co, 2 * modes[0], modes[1], generator=g))
    mode = 1 if film_mode is None else film_mode
    w_packed = sp.pack_weights_2d(ws)
    y = torch.ops.nps_torch.spectral_dft2d_fwd(x, w_packed, *modes, film,
                                               mode)
    assert y.is_contiguous() and y.shape == (b, co, 12, 10)
    torch.testing.assert_close(
        y, sp.spectral_conv_2d_plain(x, ws, modes, film, mode),
        rtol=1e-5, atol=1e-6)
    torch.library.opcheck(torch.ops.nps_torch.spectral_dft2d_fwd.default,
                          (x, w_packed, *modes, film, mode))


def test_no_grad_path_calls_the_ops(engine):
    """A model apply without gradients goes through both custom ops (the
    exported graph below keeps them); with gradients, through neither."""
    u0, cond, sc = _inputs()
    seen = []

    class Recorder(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))

    x = torch.from_numpy(u0)
    pos = engine._pos(B)
    with Recorder(), torch.no_grad():
        engine.model(x, cond=torch.from_numpy(cond), pos=pos,
                     spatial_cond=torch.from_numpy(sc))
    ops = {s for s in seen if "nps_torch" in s}
    assert ops == {"nps_torch.gn1_gelu_fwd", "nps_torch.spectral_dft2d_fwd"}
    seen.clear()
    with Recorder():
        engine.model(x, cond=torch.from_numpy(cond), pos=pos,
                     spatial_cond=torch.from_numpy(sc)).sum().backward()
    assert not any("nps_torch" in s for s in seen)


# ---- the artifact ----------------------------------------------------------

def test_artifact_round_trip_equals_engine(engine, artifact):
    """Reload and serve without the model code: the engine's rollout, at the
    export's batch and at a batch never seen at export; include_init; the
    conditioning the artifact was exported with is required, no other."""
    art = load_exported(artifact)
    assert art.meta["has_cond"] and art.meta["has_spatial_cond"]
    assert art.meta["u0_shape"] == ["b", 1, TW, NX1, NX2]
    assert art.meta["device"] == "cpu" and art.n_steps == N_STEPS
    u0, cond, sc = _inputs()
    ref = engine.rollout(u0, N_STEPS, cond=cond, spatial_cond=sc)
    out = art.rollout(u0, cond=cond, spatial_cond=sc)
    assert out.shape == (B, 1, N_STEPS * TW, NX1, NX2)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)

    u3, c3, s3 = _inputs(b=3, seed=4)
    ref3 = engine.rollout(u3, N_STEPS, cond=c3, spatial_cond=s3)
    np.testing.assert_allclose(art.rollout(u3, cond=c3, spatial_cond=s3),
                               ref3, rtol=1e-5, atol=1e-6)

    full = art.rollout(u0, cond=cond, spatial_cond=sc, include_init=True)
    np.testing.assert_array_equal(full[:, :, :TW], u0)
    np.testing.assert_allclose(full[:, :, TW:], ref, rtol=1e-5, atol=1e-6)

    with pytest.raises(ValueError, match="cond"):
        art.rollout(u0, spatial_cond=sc)
    with pytest.raises(ValueError, match="spatial_cond"):
        art.rollout(u0, cond=cond)


def test_artifact_matches_jax_engine(engine, artifact):
    """The artifact against nps_tpu's engine on the same weights: the
    port's state_dict carried into the JAX tree by convert_state_dict."""
    from nps_tpu.compat import convert_state_dict

    jeng = JaxEngine.from_config(f"nps_tpu/configs/train/{CFG}",
                                 pde=JaxPDE2D(**PDE_KW), overrides=OVERRIDES)
    jeng.params = {"params": {"inner": jax.tree_util.tree_map(
        jnp.asarray, convert_state_dict(engine.model.state_dict())[
            "params"])}}
    u0, cond, sc = _inputs()
    with jax.default_matmul_precision("highest"):
        ref = jeng.rollout(u0, n_steps=N_STEPS, cond=cond, spatial_cond=sc)
    out = load_exported(artifact).rollout(u0, cond=cond, spatial_cond=sc)
    assert out.shape == ref.shape
    nrmse = np.sqrt(np.mean((out - ref) ** 2) / np.mean(ref ** 2))
    assert nrmse < NRMSE


def _program(path):
    data = Path(path).read_bytes()
    off = len(ARTIFACT_MAGIC)
    hlen = int.from_bytes(data[off:off + 8], "little")
    return torch.export.load(io.BytesIO(data[off + 8 + hlen:]))


def test_exported_graph_keeps_both_kernels_as_custom_ops(artifact):
    """The graph holds the two kernels as nps_torch nodes and otherwise only
    ATen ops; the spectral layers' packs are constants, their raw weights
    are not carried."""
    program = _program(artifact)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    custom = {t for t in targets if t.startswith("nps_torch.")}
    assert custom == {"nps_torch.gn1_gelu_fwd.default",
                      "nps_torch.spectral_dft2d_fwd.default"}
    assert targets.count("nps_torch.spectral_dft2d_fwd.default") == 2
    # 2 blocks x 16 GN+GELU per U-FNO block
    assert targets.count("nps_torch.gn1_gelu_fwd.default") == 32
    assert all(t.startswith(("aten.", "nps_torch.", "<built-in"))
               for t in targets), set(targets)
    packs = [k for k in program.constants if k.endswith("w_packed")]
    assert len(packs) == 2
    assert not any(k.endswith(("weights1", "weights2"))
                   for k in program.state_dict)


def test_artifact_serves_with_the_op_registrations_only(engine, artifact):
    """A process that imports torch and the port's op registrations, and
    nothing of the model code or config system, serves the artifact."""
    u0, cond, sc = _inputs()
    ref = engine.rollout(u0, 1, cond=cond, spatial_cond=sc)
    code = (
        "import io, sys\n"
        "import numpy as np, torch\n"
        "import nps_tpu_torch.ops.library\n"
        "data = open(sys.argv[1], 'rb').read()\n"
        "h = int.from_bytes(data[8:16], 'little')\n"
        "m = torch.export.load(io.BytesIO(data[16 + h:])).module()\n"
        "a = np.load(sys.argv[2])\n"
        "out = m(*(torch.from_numpy(a[k]) for k in ('u0', 'cond', 'sc')))\n"
        "np.save(sys.argv[3], out.detach().numpy())\n"
        "bad = [k for k in sys.modules if k.startswith('nps_tpu_torch.') and\n"
        "       k.split('.')[1] in ('models', 'configs', 'inference',\n"
        "                           'train')]\n"
        "assert not bad, bad\n")
    tmp = Path(artifact).parent
    np.savez(tmp / "in.npz", u0=u0, cond=cond, sc=sc)
    res = subprocess.run(
        [sys.executable, "-c", code, artifact, str(tmp / "in.npz"),
         str(tmp / "out.npy")], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    np.testing.assert_allclose(np.load(tmp / "out.npy"), ref, rtol=1e-5,
                               atol=1e-6)


def test_artifact_rejects_bad_magic_and_another_device(artifact, tmp_path):
    bad = tmp_path / "notanartifact.npst"
    bad.write_bytes(b"garbage-bytes")
    with pytest.raises(ValueError, match="artifact"):
        load_exported(str(bad))
    jax_magic = tmp_path / "jax.npsx"
    jax_magic.write_bytes(b"NPSX0001" + Path(artifact).read_bytes()[8:])
    with pytest.raises(ValueError, match="artifact"):
        load_exported(str(jax_magic))
    with pytest.raises(ValueError, match="exported on cpu"):
        load_exported(artifact, device="cuda")


def test_static_batch_artifact_without_conditioning(tmp_path):
    """A static-batch export of a model served without spatial
    conditioning: its header pins the batch, and passing spatial
    conditioning raises."""
    pde = PDE2D(**dict(PDE_KW, n_cond_spatial=0))
    eng = SurrogateEngine.from_config(
        "nps_tpu_torch/configs/train/cfg_twophase_ufno_fno.py", pde=pde,
        overrides=[f"--time_window={TW}", "--model.hidden_features=16",
                   "--model.fno_modes=4", "--model.enforce_spatial_cond=false"],
        device="cpu")
    eng.init_params(seed=1)
    u0, cond, sc = _inputs()
    path = str(tmp_path / "static.npst")
    eng.export_rollout(path, 1, u0, cond=cond, batch_poly=False)
    art = load_exported(path)
    assert art.meta["u0_shape"][0] == B and not art.meta["has_spatial_cond"]
    np.testing.assert_allclose(art.rollout(u0, cond=cond),
                               eng.rollout(u0, 1, cond=cond),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="without spatial_cond"):
        art.rollout(u0, cond=cond, spatial_cond=sc)


def test_export_cli(engine, tmp_path):
    """``python -m nps_tpu_torch.export_artifact`` from a checkpoint: the
    artifact serves what the engine with that checkpoint serves."""
    from nps_tpu_torch import export_artifact

    ckpt = tmp_path / "w.pt"
    torch.save(engine.model.state_dict(), ckpt)
    out = tmp_path / "cli.npst"
    export_artifact.main([
        "-C", f"nps_tpu_torch/configs/train/{CFG}", "--checkpoint",
        str(ckpt), "--out", str(out), "--n-steps", "1", "--device", "cpu",
        "--n-cond-static", "2", "--n-cond-spatial", "2",
        f"--base_resolution=[{NT},{NX1},{NX2}]", *OVERRIDES])
    u0, cond, sc = _inputs()
    # the CLI's PDE spans [0, 1] in time: the decoder's dt differs from the
    # fixture's, so the reference is an engine built the same way
    ref = SurrogateEngine.from_config(
        f"nps_tpu_torch/configs/train/{CFG}", checkpoint=str(ckpt),
        pde=PDE2D(tmin=0.0, tmax=1.0, nt=NT, L1=1.0, L2=NX2 / NX1, nx1=NX1,
                  nx2=NX2, x=None, name="twophase", n_cond_static=2,
                  n_cond_spatial=2),
        overrides=OVERRIDES, device="cpu")
    np.testing.assert_allclose(
        load_exported(str(out)).rollout(u0, cond=cond, spatial_cond=sc),
        ref.rollout(u0, 1, cond=cond, spatial_cond=sc), rtol=1e-5, atol=1e-6)


def test_gnn_engine_refuses_export_and_cpu_refuses_capture(engine, tmp_path):
    pde = PDE2D(**dict(PDE_KW, nx1=12, nx2=8))
    eng = SurrogateEngine.from_config(
        "nps_tpu_torch/configs/train/cfg_twophase_gnn.py", pde=pde,
        overrides=[f"--time_window={TW}", "--model.hidden_features=16",
                   "--model.hidden_blocks=2"], device="cpu")
    u0 = np.zeros((1, 1, TW, 12, 8), np.float32)
    with pytest.raises(NotImplementedError, match="grid models"):
        eng.export_rollout(str(tmp_path / "g.npst"), 1, u0)
    u0, cond, sc = _inputs()
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.rollout(u0, 1, cond=cond, spatial_cond=sc, captured=True)
