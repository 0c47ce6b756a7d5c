"""The port's host utilities (``nps_tpu_torch/utils``: ``DatasetToInterface``,
``index_batch`` / ``handle_item``, ``RunningStats``, ``isclose_iter``)
against their ``nps_tpu.utils`` counterparts on the same inputs, made from
a seed with numpy. Host numpy, so the bar is equality (the running
statistics: the same float64 operations, rtol 1e-12)."""

import numpy as np
import pytest
import torch


def _batch(rng):
    return (rng.standard_normal((6, 2, 3)).astype(np.float32),
            {"a": rng.standard_normal((6, 4)), "b": [np.arange(6), None]},
            None, 7, "name", [rng.standard_normal((6,)), (np.ones((6, 2)),)])


def _same(a, b):
    """Equal structures of equal leaves (arrays by value)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if hasattr(a, "shape"):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


@pytest.mark.parametrize("idx", [0, 3, [1, 4], slice(2, 5)],
                         ids=["int0", "int3", "list", "slice"])
def test_index_batch_matches_jax(idx):
    """``index_batch`` on a batch of arrays, dicts, lists, None and scalars
    selects what the JAX package's selects; on tensors the same values."""
    from nps_tpu.utils import index_batch as jax_index_batch
    from nps_tpu_torch.utils import index_batch

    batch = _batch(np.random.default_rng(0))
    got, ref = index_batch(batch, idx), jax_index_batch(batch, idx)
    assert _same(got, ref)
    tensors = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                    for a in batch)
    got = index_batch(tensors, idx)
    assert np.array_equal(got[0].numpy(), ref[0])


def test_handle_item_matches_jax():
    from nps_tpu.utils import handle_item as jax_handle_item
    from nps_tpu_torch.utils import handle_item

    item = _batch(np.random.default_rng(1))[1]
    idx = np.array([5, 0])
    assert _same(handle_item(item, idx), jax_handle_item(item, idx))
    assert handle_item(None, idx) is None


@pytest.mark.parametrize("log_domain", [False, True])
def test_running_stats_match_jax(log_domain):
    """Batched pushes of different sizes (one empty of effect: a single
    value) give the JAX package's summary, which is numpy's over all the
    values."""
    from nps_tpu.utils import RunningStats as JaxRunningStats
    from nps_tpu_torch.utils import RunningStats

    rng = np.random.default_rng(2)
    chunks = [rng.random(n) + 0.1 for n in (5, 1, 17, 40)]
    got, ref = RunningStats(log_domain), JaxRunningStats(log_domain)
    for c in chunks:
        got.push(c)
        ref.push(c)
    g, r = got.summary(), ref.summary()
    assert g.keys() == r.keys() and g["n"] == r["n"] == 63
    for k in ("mean", "var", "std", "min", "max"):
        np.testing.assert_allclose(g[k], r[k], rtol=1e-12, err_msg=k)
    values = np.concatenate(chunks)
    values = np.log(values) if log_domain else values
    np.testing.assert_allclose(g["mean"], values.mean(), rtol=1e-12)
    np.testing.assert_allclose(g["var"], values.var(), rtol=1e-10)
    assert RunningStats().var == JaxRunningStats().var == 0.0


def _pairs():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((3, 4))
    return [
        ({"x": a, "y": [1.0, 2.0]}, {"x": a + 1e-9, "y": [1.0, 2.0]}),
        ({"x": a}, {"x": a + 1e-3}),
        ({"x": a}, {"z": a}),
        ([a, a], [a]),
        (1.0, 1.0 + 1e-7),
        (1.0, 1.1),
        (a, a[:2]),
        ("s", "s"),
        ((a, {"k": 3}), (a, {"k": 3})),
    ]


@pytest.mark.parametrize("i", range(len(_pairs())))
def test_isclose_iter_matches_jax(i):
    """The same verdict as the JAX package's on each pair; a tensor pair
    (on the host) as its numpy pair."""
    from nps_tpu.utils import isclose_iter as jax_isclose_iter
    from nps_tpu_torch.utils import isclose_iter

    x, y = _pairs()[i]
    assert isclose_iter(x, y) == jax_isclose_iter(x, y)
    if isinstance(x, np.ndarray):
        assert (isclose_iter(torch.from_numpy(x), torch.from_numpy(y))
                == jax_isclose_iter(x, y))


@pytest.mark.parametrize("set_as", ["train", "valid", "test", "all"])
def test_dataset_to_interface_matches_jax(set_as):
    """Each split the adapter exposes, its interface, PDE and repr, as the
    JAX package's adapter gives them for the same dataset."""
    from nps_tpu.common.interfaces import D as JD
    from nps_tpu.utils.dataset_adapter import (
        DatasetToInterface as JaxDatasetToInterface)
    from nps_tpu_torch.common.interfaces import D
    from nps_tpu_torch.utils.dataset_adapter import DatasetToInterface

    data = [np.full((2,), i) for i in range(4)]
    got = DatasetToInterface(data, D.sim2d, set_as, pde="pde")
    ref = JaxDatasetToInterface(data, JD.sim2d, set_as, pde="pde")
    for split in ("train", "valid", "test"):
        assert (getattr(got, split) is None) == (getattr(ref, split) is None)
        assert getattr(got, split) in (None, data)
    assert got.data_interface.name == ref.data_interface.name == "sim2d"
    assert got.pde == ref.pde == "pde"
    assert repr(got).split("-")[:2] == repr(ref).split("-")[:2]


def test_dataset_to_interface_refusals_match_jax():
    from nps_tpu.utils.dataset_adapter import (
        DatasetToInterface as JaxDatasetToInterface)
    from nps_tpu_torch.common.interfaces import D
    from nps_tpu_torch.utils.dataset_adapter import DatasetToInterface

    for cls, interface in ((DatasetToInterface, D.sim1d),
                           (JaxDatasetToInterface, None)):
        with pytest.raises(ValueError, match="set_as"):
            cls([], interface, "bogus")
    with pytest.raises(ValueError, match="interface"):
        DatasetToInterface([], "sim9")
    with pytest.raises(ValueError, match="interface"):
        JaxDatasetToInterface([], "sim9")
