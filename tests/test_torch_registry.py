"""The port's registry against ``repro.tuning.registry``: the same
fingerprint string for the same COO, the same cached schedules and
permutations, and cache semantics keyed by device."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import csc as jfmt  # noqa: E402
from repro.graphs import synth as jsynth  # noqa: E402
from repro.tuning import registry as jreg  # noqa: E402
from repro_torch.core import csc as tfmt  # noqa: E402
from repro_torch.core import executor as texe  # noqa: E402
from repro_torch.graphs import synth as tsynth  # noqa: E402
from repro_torch.tuning import registry as treg  # noqa: E402

FIELDS = ("win_id", "col_block", "val", "local_row", "local_col", "row_map")


@pytest.fixture(autouse=True)
def _fresh_caches():
    treg.clear_caches()
    yield
    treg.clear_caches()


def _pair(n=300, density=0.03, alpha=0.9, seed=7):
    return (tsynth.power_law_adjacency(n, density, alpha, seed=seed),
            jsynth.power_law_adjacency(n, density, alpha, seed=seed))


@pytest.mark.parametrize("seed", [0, 7])
def test_fingerprint_is_the_reference_string(seed):
    ta, ja = _pair(seed=seed)
    fp = treg.graph_fingerprint(ta)
    assert fp == jreg.graph_fingerprint(ja)
    assert treg.graph_fingerprint(tfmt.pad_coo(ta, ta.nnz + 11)) == fp
    dense = np.eye(6, dtype=np.float32)
    assert treg.graph_fingerprint(tfmt.coo_from_dense(dense)) == \
        jreg.graph_fingerprint(jfmt.coo_from_dense(dense))
    tb, _ = _pair(seed=seed + 1)
    assert treg.graph_fingerprint(tb) != fp


@pytest.mark.parametrize("kw", [
    dict(), dict(nnz_per_step=32, rows_per_window=16, cols_per_block="auto"),
    dict(nnz_per_step=16, rows_per_window=8, balanced=False),
    dict(nnz_per_step=32, rows_per_window=16, reorder="island")])
def test_get_schedule_matches_reference_and_caches(kw):
    ta, ja = _pair()
    ts = treg.get_schedule(ta, **kw)
    js = jreg.get_schedule(ja, **kw)
    for f in FIELDS:
        assert np.array_equal(getattr(ts, f), getattr(js, f)), f
    assert treg.get_schedule(ta, **kw) is ts


def test_get_reorder_matches_reference():
    ta, ja = _pair()
    assert treg.get_reorder(ta, "none") == (None, None)
    for strategy in ("degree", "island"):
        tp, ti = treg.get_reorder(ta, strategy)
        jp, ji = jreg.get_reorder(ja, strategy)
        assert np.array_equal(tp, jp) and np.array_equal(ti, ji)
        assert treg.get_reorder(ta, strategy)[0] is tp


def test_get_executor_caches_by_graph_config_and_device():
    ta, _ = _pair()
    ex = treg.get_executor(ta, nnz_per_step=32, rows_per_window=16, device="cpu")
    assert ex.device == torch.device("cpu")
    again = treg.get_executor(tfmt.COO(ta.row.clone(), ta.col.clone(), ta.val.clone(),
                                       ta.shape),
                              nnz_per_step=32, rows_per_window=16, device="cpu")
    assert again is ex
    other = treg.get_executor(ta, nnz_per_step=32, rows_per_window=16, routing="onehot",
                              device="cpu")
    assert other is not ex and other.sched is ex.sched
    reordered = treg.get_executor(ta, reorder="degree", device="cpu")
    assert reordered.row_unperm is not None


def test_multi_device_requests_raise():
    """What still raises of a multi-device request: a device beside a mesh
    (a single-device pin contradicts it, as in the reference), a device
    count beyond the host's cards, a count that contradicts the mesh, and a
    mesh that is not a list of devices. A mesh of host positions builds the
    sharded executor, keyed apart from the single-device one."""
    ta, _ = _pair()
    s = treg.get_schedule(ta)
    with pytest.raises(ValueError, match="cannot be combined"):
        treg.get_executor(ta, n_devices=2, device="cpu")
    with pytest.raises(ValueError, match="cannot be combined"):
        treg.executor_for_schedule(s, mesh=["cpu", "cpu"], device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        treg.get_executor(ta, n_devices=torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="contradicts"):
        treg.get_executor(ta, n_devices=3, mesh=["cpu", "cpu"])
    with pytest.raises(ValueError, match="list of devices"):
        treg.executor_for_schedule(s, mesh="cpu")
    ex = treg.executor_for_schedule(s, mesh=["cpu", "cpu"])
    assert isinstance(ex, texe.ShardedScheduleExecutor) and ex.n_devices == 2
    assert treg.executor_for_schedule(s, device="cpu") is not ex


def test_executor_for_schedule_is_identity_keyed():
    ta, _ = _pair()
    s = treg.get_schedule(ta, nnz_per_step=32, rows_per_window=16)
    ex = treg.executor_for_schedule(s, device="cpu")
    assert treg.executor_for_schedule(s, device="cpu") is ex
    assert treg.executor_for_schedule(s, routing="onehot", device="cpu") is not ex


def test_release_graph_drops_schedules_executors_and_uploads():
    ta, tb = _pair(seed=1)[0], _pair(seed=2)[0]
    fa = treg.graph_fingerprint(ta)
    ex_a = treg.get_executor(ta, routing="onehot", reorder="degree", device="cpu")
    ex_b = treg.get_executor(tb, device="cpu")
    texe.device_step_arrays(ex_a.sched, "cpu")  # the kernels' upload
    assert (id(ex_a.sched), "cpu") in texe._DEVICE_STEPS
    treg.release_graph(fa)
    assert (id(ex_a.sched), "cpu") not in texe._DEVICE_STEPS
    assert treg.get_executor(ta, routing="onehot", reorder="degree", device="cpu") \
        is not ex_a
    assert treg.get_executor(tb, device="cpu") is ex_b


def test_cuda_spellings_resolve_to_one_device_key(monkeypatch):
    """``"cuda"``, ``torch.device("cuda")`` and ``None`` all name the current
    card, ``cuda:<current_device()>``, so the caches key them alike."""
    from repro_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    keys = {str(resolve_device(d)) for d in ("cuda", torch.device("cuda"), None, "cuda:0")}
    assert keys == {"cuda:0"}
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")
