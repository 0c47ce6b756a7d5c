"""The port stands alone: ``nps_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and the engine never falls back to the CPU
on its own."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "nps_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "nps_tpu")


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import nps_tpu_torch, nps_tpu_torch.inference\n"
        "for m in pkgutil.walk_packages(nps_tpu_torch.__path__, "
        "'nps_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    loaded = res.stdout.split()
    assert "nps_tpu_torch.inference" in loaded
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_engine_without_device_refuses_to_run_on_cpu(monkeypatch):
    from nps_tpu_torch.inference import SurrogateEngine
    from nps_tpu_torch.pde import PDE2D

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pde = PDE2D(tmin=0, tmax=10, nt=51, L1=1.0, L2=0.7, nx1=24, nx2=16,
                x=None, name="twophase", n_cond_static=2, n_cond_spatial=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        SurrogateEngine.from_config(
            "nps_tpu_torch/configs/train/cfg_twophase_ufno.py", pde=pde,
            overrides=["--model.hidden_features=8"])


def test_train_cli_without_device_refuses_to_run_on_cpu(monkeypatch):
    from nps_tpu_torch import train_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["prog", "-C", "nps_tpu_torch/configs/train/cfg_twophase_ufno.py",
            "--model.hidden_features=8"]
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.cli(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.cli(argv + ["--device", "cuda"])


# the modules the serving artifact, the captured rollout, the MP-GNN and
# the ns512 serving slice added: each imports in a fresh process with no JAX
# and nothing of nps_tpu
NEW_MODULES = ("nps_tpu_torch.ops.library", "nps_tpu_torch.export_artifact",
               "nps_tpu_torch.common.graph",
               "nps_tpu_torch.common.data_creator",
               "nps_tpu_torch.models.gnn",
               "nps_tpu_torch.configs.train.cfg_twophase_gnn",
               "nps_tpu_torch.models.config", "nps_tpu_torch.bf16_probe",
               "nps_tpu_torch.configs.train.cfg_ns512_ufno")


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_module_imports_alone_without_jax(module):
    assert (PKG / (module.split(".", 1)[1].replace(".", "/") + ".py")
            ).exists(), module
    code = (f"import sys; import importlib; sys.argv = ['x']\n"
            f"importlib.import_module({module!r})\n"
            "print('\\n'.join(sorted(sys.modules)))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    bad = [m for m in res.stdout.split() if _forbidden(m)]
    assert not bad, bad


def test_engine_refuses_a_captured_rollout_without_a_card():
    from nps_tpu_torch.inference import SurrogateEngine
    from nps_tpu_torch.pde import PDE2D

    pde = PDE2D(tmin=0, tmax=10, nt=51, L1=1.0, L2=0.7, nx1=12, nx2=8,
                x=None, name="twophase", n_cond_static=2, n_cond_spatial=2)
    eng = SurrogateEngine.from_config(
        "nps_tpu_torch/configs/train/cfg_twophase_gnn.py", pde=pde,
        overrides=["--model.hidden_features=8", "--model.hidden_blocks=1",
                   "--time_window=5"], device="cpu")
    u0 = np.zeros((1, 1, 5, 12, 8), np.float32)
    with pytest.raises(RuntimeError, match="CUDA device"):
        eng.rollout(u0, 1, cond=np.zeros((1, 2), np.float32), captured=True)
