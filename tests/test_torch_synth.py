"""Parity of the port's synthetic datasets with ``repro.graphs.synth``:
adjacency and features bit-identical for the same seed and scale; labels
identical wherever the teacher's top two logits are not a near tie."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graphs import synth as jsynth  # noqa: E402
from repro_torch.core import csc as tfmt  # noqa: E402
from repro_torch.graphs import synth as tsynth  # noqa: E402


def _eq_coo(t, j):
    for f in ("row", "col", "val"):
        assert np.array_equal(tfmt.to_numpy(getattr(t, f)), np.asarray(getattr(j, f)))
    assert tuple(t.shape) == tuple(j.shape)


def test_dataset_stats_are_the_reference_table():
    assert tsynth.DATASET_STATS == jsynth.DATASET_STATS


@pytest.mark.parametrize("n,density,alpha,seed", [
    (200, 0.02, 1.1, 0), (500, 0.01, 0.7, 3), (123, 0.08, 0.6, 123)])
def test_power_law_adjacency_and_features(n, density, alpha, seed):
    _eq_coo(tsynth.power_law_adjacency(n, density, alpha, seed=seed),
            jsynth.power_law_adjacency(n, density, alpha, seed=seed))
    _eq_coo(tsynth.power_law_adjacency(n, density, alpha, seed=seed, normalize=False,
                                       max_degree=16),
            jsynth.power_law_adjacency(n, density, alpha, seed=seed, normalize=False,
                                       max_degree=16))
    assert np.array_equal(tsynth.sparse_features(n, 40, 0.05, seed=seed),
                          jsynth.sparse_features(n, 40, 0.05, seed=seed))


@pytest.mark.parametrize("name,scale", [("cora", 4), ("pubmed", 32), ("citeseer", 8)])
def test_make_dataset_matches_reference(name, scale):
    t = tsynth.make_dataset(name, seed=1, scale=scale, device="cpu")
    j = jsynth.make_dataset(name, seed=1, scale=scale)
    _eq_coo(t.adj, j.adj)
    assert np.array_equal(t.features, j.features)
    assert (t.num_nodes, t.num_features, t.num_classes, t.hidden) == (
        j.num_nodes, j.num_features, j.num_classes, j.hidden)
    # the teacher's logits, in float64: labels may differ only at near ties
    rng = np.random.default_rng(1 + 3)
    w1 = rng.standard_normal((j.features.shape[1], 32)).astype(np.float32)
    w2 = rng.standard_normal((32, j.num_classes)).astype(np.float32)
    dense = np.asarray(tfmt.to_numpy(tfmt.coo_to_dense(t.adj)), np.float64)
    h = np.maximum(dense @ (j.features @ w1).astype(np.float64), 0)
    logits = dense @ (h.astype(np.float32) @ w2).astype(np.float64)
    top2 = np.sort(logits, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) >= 1e-5
    assert clear.mean() > 0.95
    assert np.array_equal(t.labels[clear], j.labels[clear])
    assert t.labels.dtype == np.int32


def test_csr_csc_properties():
    t = tsynth.make_dataset("cora", seed=0, scale=8, device="cpu")
    assert int(t.adj_csr.indptr[-1]) == t.adj.nnz
    assert int(t.adj_csc.indptr[-1]) == t.adj.nnz
