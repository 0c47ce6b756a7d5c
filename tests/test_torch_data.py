"""The port's data path against ``nps_tpu``'s: the synthetic generator, the
twophase dataset and its split, the host loader's shuffled batches, the
device cache, the downsampling transforms and the physics step
post-processing. Data and loaders are numpy, so the bar is equality; the
post-processing runs in f32 on both sides (bar 1e-6 absolute).
"""

import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nps_tpu.common.interfaces import M as JaxM
from nps_tpu.data import transforms as jax_transforms
from nps_tpu.data.pde2d import PDE2DDataset as JaxPDE2DDataset
from nps_tpu.data.pipeline import HostDataLoader as JaxHostDataLoader
from nps_tpu.data.synthetic import generate as jax_generate
from nps_tpu.utils.process_output import process_step as jax_process_step
from nps_tpu_torch.common.interfaces import M
from nps_tpu_torch.data import transforms
from nps_tpu_torch.data.pde2d import PDE2DDataset
from nps_tpu_torch.data.pipeline import DeviceCacheLoader, HostDataLoader
from nps_tpu_torch.data.synthetic import generate
from nps_tpu_torch.utils.process_output import process_step

FILES = ("snapshots.npy", "snapshots.yaml", "conditioning.npy",
         "spatial_conditioning.npy", "split.yaml")
GEN = dict(n_sims=10, n_channels=3, nt=51, nx1=24, nx2=16, seed=3)
DS = dict(data_format="memmap", data_file="snapshots",
          conditioning="conditioning",
          spatial_conditioning="spatial_conditioning", split_file="split",
          c_filter=[1], name="twophase")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    generate(str(root / "port"), **GEN)
    jax_generate(str(root / "jax"), **GEN)
    return root


@pytest.mark.parametrize("name", FILES)
def test_generate_writes_the_jax_packages_bytes(dirs, name):
    assert filecmp.cmp(dirs / "port" / name, dirs / "jax" / name,
                       shallow=False)


def _datasets(root):
    return (PDE2DDataset(base_path=str(root), experiment="port", **DS),
            JaxPDE2DDataset(base_path=str(root), experiment="port", **DS))


def test_dataset_split_and_pde_match(dirs):
    port, ref = _datasets(dirs)
    for split in ("train", "valid", "test"):
        assert getattr(port, split).indices == getattr(ref, split).indices
    for key in ("tmin", "tmax", "nt", "dt", "L1", "L2", "nx1", "nx2",
                "n_cond_static", "n_cond_dynamic", "n_cond_spatial"):
        assert getattr(port.pde, key) == getattr(ref.pde, key), key
    np.testing.assert_array_equal(port.pde.x, ref.pde.x)


@pytest.mark.parametrize("batch_size", [3, 4])
def test_host_loader_gives_the_same_shuffled_batches(dirs, batch_size):
    port, ref = _datasets(dirs)
    pl = HostDataLoader(port.train, batch_size, seed=7)
    jl = JaxHostDataLoader(ref.train, batch_size, seed=7, process_index=0,
                           process_count=1)
    assert len(pl) == len(jl)
    for _ in range(2):  # two epochs: two permutations
        got, want = list(pl), list(jl)
        assert len(got) == len(want) == len(pl)
        for a, b in zip(got, want):
            assert len(a) == len(b) == 6
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_device_cache_loader_matches_host_loader(dirs):
    port, _ = _datasets(dirs)
    host = HostDataLoader(port.train, 3, seed=5)
    cache = DeviceCacheLoader(port.train, 3, seed=5, device="cpu")
    assert len(cache) == len(host)
    for _ in range(2):
        for a, b in zip(cache, host):
            for x, y in zip(a, b):
                assert isinstance(x, torch.Tensor)
                np.testing.assert_array_equal(x.numpy(), y)
    bf16 = DeviceCacheLoader(port.train, 3, seed=5, cache_dtype="bfloat16")
    assert next(iter(bf16))[1].dtype == torch.bfloat16


@pytest.mark.parametrize("fn,args", [
    ("get_1d_downsample_matrix", (17, 9)),
    ("get_1d_averaging_matrix", (16, 5)),
    ("get_1d_interp_matrix", (np.array([0.0, 0.1, 0.5, 0.7, 1.0]),
                              np.linspace(0, 1, 7))),
    ("get_t_downsample", (0.0, 10.0, 51)),
])
def test_transforms_match(fn, args):
    kwargs = {"ratio_nt": 5} if fn == "get_t_downsample" else {}
    np.testing.assert_array_equal(
        getattr(transforms, fn)(*args, **kwargs),
        getattr(jax_transforms, fn)(*args, **kwargs))


def test_downsample_2d_matches():
    u = np.random.default_rng(0).random((10, 24, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        transforms.downsample_2d_average_periodic(u, 2, 2),
        jax_transforms.downsample_2d_average_periodic(u, 2, 2))


@pytest.mark.parametrize("bc_mode,gnn", [
    ("delta", False), ("all_fixed_bc", False), ("all", False),
    ("simple", False), ("delta", True), ("simple", True)])
def test_process_step_div1d_matches(bc_mode, gnn):
    """The DIV1D branch (BC injection, min clipping, BC extraction), which
    the twophase path passes through. The GNN BC signal has only the delta
    and simple modes."""
    rng = np.random.default_rng(1)
    pde = type("DIV1D", (), {
        "__str__": lambda self: "DIV1D", "bc_mode": bc_mode,
        "var_mean_sd": [(0.2, 1.5), (0, 1), (0.1, 0.5), (0.3, 2.0)]})()
    sim, prev, nxt = (rng.standard_normal((2, 4, 5, 11)).astype(np.float32)
                      for _ in range(3))
    got = process_step(pde, M.AR_TB_GNN if gnn else M.AR_TB,
                       *(torch.from_numpy(a) for a in (sim, prev, nxt)))
    want = jax_process_step(pde, JaxM.AR_TB_GNN if gnn else JaxM.AR_TB,
                            *(jnp.asarray(a) for a in (sim, prev, nxt)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


def test_process_step_passes_twophase_through():
    pde = type("P", (), {"__str__": lambda self: "twophase"})()
    sim = torch.randn(2, 1, 5, 6, 4)
    out, bc = process_step(pde, M.AR_TB, sim, sim, sim)
    assert out is sim and bc is None
