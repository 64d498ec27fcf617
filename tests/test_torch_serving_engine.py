"""The port's ``GCNServingEngine`` (part 1: one device) on the CPU, against
the reference engine and the reference GCN forward on the same numpy
inputs: cold admission through the measured sweep, restart warm starts
(zero sweeps, zero rebuilds), corrupted entries, LRU/budget eviction and
re-admission without a rebuild, submit/poll/flush with EDF and deadlines,
threshold auto-flush, admission control (reject, shed), the dispatch retry
loop, failure accounting, ``stats()``, and what part 1 leaves out. Mirrors
``tests/test_serving_engine.py``, ``tests/test_overload.py``, the
single-device cases of ``tests/test_placement.py`` and the dispatch cases of
``tests/test_faults.py``, case for case."""
import dataclasses
import time
from typing import NamedTuple

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import gcn as jgcn  # noqa: E402
from repro.graphs import synth as jsynth  # noqa: E402
from repro.serving import gcn_engine as jge  # noqa: E402
from repro.tuning import registry as jreg  # noqa: E402
from repro.tuning import runner as jrun  # noqa: E402
from repro_torch.core import executor as texe  # noqa: E402
from repro_torch.core import gcn as tgcn  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core.executor import FAULTS, InjectedFault  # noqa: E402
from repro_torch.graphs import synth as tsynth  # noqa: E402
from repro_torch.serving import gcn_engine as ge  # noqa: E402
from repro_torch.serving.errors import (FlushError, RequestFailure,  # noqa: E402
                                        UnknownGraphError)
from repro_torch.serving.placement import (REPLICATED, SHARDED, SINGLE,  # noqa: E402
                                           MeshPlacer, Placement)
from repro_torch.serving.policy import LearnedServiceTimePolicy  # noqa: E402
from repro_torch.serving.types import (ACCEPTED, REJECTED, SHED,  # noqa: E402
                                       SubmitTicket)
from repro_torch.tuning import registry, runner  # noqa: E402
from repro_torch.tuning.store import TuningStore  # noqa: E402

N_NODES = 220
N_FEATS = 20
N_CLASSES = 5

FAST_SWEEP = [
    dict(nnz_per_step=64, rows_per_window=32, cols_per_block=None,
         window_nnz=None, routing="gather"),
    dict(nnz_per_step=128, rows_per_window=64, cols_per_block=None,
         window_nnz=None, routing="gather"),
]
FAST_KW = dict(iters=1, warmup=1, sweep=FAST_SWEEP, bf16_report=False)
TOL = 1e-3  # the reference engine tests' tolerance
#: counters the port keeps and the reference does not: ``requests_copied``
#: (requests whose features had to be copied to the serving device)
PORT_COUNTERS = {"requests_copied"}


class W(NamedTuple):
    a: object  # the port's COO
    params: dict  # the port's weights (torch, from the numpy ones)
    x: np.ndarray
    ja: object  # the reference's COO
    jparams: dict  # numpy weights


@pytest.fixture(autouse=True)
def _fresh_caches():
    registry.clear_caches()
    jreg.clear_caches()
    FAULTS.clear()
    yield
    registry.clear_caches()
    jreg.clear_caches()
    FAULTS.clear()


def _workload(seed) -> W:
    cfg = jgcn.GCNConfig(N_FEATS, 16, N_CLASSES)
    jparams = {k: np.asarray(v)
               for k, v in jgcn.init_params(cfg, jax.random.PRNGKey(seed)).items()}
    x = np.random.default_rng(seed).random((N_NODES, N_FEATS)).astype(np.float32)
    return W(tsynth.power_law_adjacency(N_NODES, 0.03, 0.9, seed=seed),
             tgcn.params_from_jax(jparams, "cpu"), x,
             jsynth.power_law_adjacency(N_NODES, 0.03, 0.9, seed=seed), jparams)


def _gold(w: W, x) -> np.ndarray:
    """The reference's plain COO forward on the same inputs."""
    return np.asarray(jgcn.forward(w.jparams, w.ja, jnp.asarray(x)))


def _engine(root, **kw):
    kw.setdefault("autotune_kwargs", FAST_KW)
    return ge.GCNServingEngine(store_root=root, device="cpu", **kw)


def _identity(eng):
    st = eng.stats()
    assert st["submitted"] == (st["queue_served"] + st["shed"] + st["rejected"]
                               + st["dropped"] + st["pending_requests"]), st
    return st


def _outstanding_settled(eng):
    assert all(v == 0.0 for v in eng._dev_outstanding.values()), eng._dev_outstanding


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# Admission, warm starts, eviction (tests/test_serving_engine.py)
# ---------------------------------------------------------------------------


def test_add_and_serve_matches_reference(tmp_path):
    w = _workload(0)
    eng = _engine(tmp_path / "t")
    rep = eng.add_graph("g", w.a, w.params)
    assert not rep.warm_start and rep.tune_seconds > 0
    assert rep.placement == Placement(SINGLE, 0, 1)
    np.testing.assert_allclose(_np(eng.infer("g", w.x)), _gold(w, w.x), atol=TOL)
    xs = [w.x, w.x * 0.5, w.x + 0.1]
    out = eng.serve_batch("g", xs)
    assert out.shape == (3, N_NODES, N_CLASSES) and out.dtype == torch.float32
    jeng = jge.GCNServingEngine(store_root=tmp_path / "j", autotune_kwargs=FAST_KW)
    jeng.add_graph("g", w.ja, w.jparams)
    jout = np.asarray(jeng.serve_batch("g", xs))
    np.testing.assert_allclose(_np(out), jout, atol=TOL)
    for i, xi in enumerate(xs):
        np.testing.assert_allclose(_np(out[i]), _gold(w, xi), atol=TOL)
    with pytest.raises(ValueError, match="already registered"):
        eng.add_graph("g", w.a, w.params)


def test_engine_matches_reference_engine_decision_for_decision(tmp_path, monkeypatch):
    """Under the same deterministic timings both engines tune the same
    config, report the same admission, serve the same scripted traffic
    with equal logits and end with equal counters."""
    cost = (lambda ex, b, iters, warmup: float(ex.sched.issued_slots))
    monkeypatch.setattr(runner, "measure_candidate", cost)
    monkeypatch.setattr(jrun, "measure_candidate", cost)
    ws = [_workload(90), _workload(91)]
    eng = _engine(tmp_path / "t", max_batch=3, max_queue_depth=4)
    jeng = jge.GCNServingEngine(store_root=tmp_path / "j", max_batch=3,
                                max_queue_depth=4, autotune_kwargs=FAST_KW)
    for i, w in enumerate(ws):
        r = eng.add_graph(f"g{i}", w.a, w.params)
        jr = jeng.add_graph(f"g{i}", w.ja, w.jparams)
        assert (dataclasses.asdict(dataclasses.replace(r.config, measured_us=0))
                == dataclasses.asdict(dataclasses.replace(jr.config, measured_us=0)))
        assert r.warm_start == jr.warm_start
        assert dataclasses.astuple(r.placement) == dataclasses.astuple(jr.placement)
    now = 1000.0
    script = [("g0", 0.5, 50.0), ("g1", 1.0, None), ("g0", 2.0, 5.0),
              ("g0", 3.0, None), ("g1", 0.25, 1.0), ("g0", 1.5, 9.0)]
    for gid, scale, dl in script:
        x = ws[int(gid[1])].x * scale
        t, jt = (e.submit(gid, x, deadline_s=dl, now=now) for e in (eng, jeng))
        assert (t.rid, t.status) == (jt.rid, jt.status)
    out, jout = eng.flush(), jeng.flush()
    assert sorted(out) == sorted(jout)
    for gid in out:
        np.testing.assert_allclose(_np(out[gid]), np.asarray(jout[gid]), atol=TOL)
    keys = ("submitted", "queue_served", "rejected", "shed", "batches", "requests",
            "store_misses", "store_hits", "evictions")
    assert {k: eng.counters[k] for k in keys} == {k: jeng.counters[k] for k in keys}
    assert set(eng.counters) == set(jeng.counters) | PORT_COUNTERS
    assert set(eng.stats()) == set(jeng.stats()) | PORT_COUNTERS


def test_restart_warm_start_zero_sweeps_zero_rebuilds(tmp_path, monkeypatch):
    w = _workload(1)
    eng = _engine(tmp_path)
    eng.add_graph("g", w.a, w.params)
    ref = _np(eng.infer("g", w.x))
    assert eng.counters["store_misses"] == 1
    registry.clear_caches()
    monkeypatch.setattr(runner, "measure_candidate",
                        lambda *a_, **k: pytest.fail("sweep on warm start"))
    monkeypatch.setattr(tsched, "build_balanced_schedule",
                        lambda *a_, **k: pytest.fail("rebuild on warm start"))
    eng2 = _engine(tmp_path)
    rep = eng2.add_graph("g", w.a, w.params)
    assert rep.warm_start and rep.tune_seconds == 0.0
    assert eng2.counters["store_hits"] == 1 and eng2.counters["store_misses"] == 0
    assert np.array_equal(_np(eng2.infer("g", w.x)), ref)


@pytest.mark.parametrize("reorder", ["degree", "island"])
def test_warm_start_adopts_the_stored_permutation(tmp_path, monkeypatch, reorder):
    w = _workload(2)
    sweep = [dict(FAST_SWEEP[0], reorder=reorder)]
    kw = dict(FAST_KW, sweep=sweep)
    eng = _engine(tmp_path, autotune_kwargs=kw)
    assert eng.add_graph("g", w.a, w.params).config.reorder == reorder
    ref = _np(eng.infer("g", w.x))
    np.testing.assert_allclose(ref, _gold(w, w.x), atol=TOL)
    registry.clear_caches()
    monkeypatch.setattr("repro_torch.core.reorder.permutation",
                        lambda *a_, **k: pytest.fail("permutation recomputed"))
    monkeypatch.setattr(tsched, "build_balanced_schedule",
                        lambda *a_, **k: pytest.fail("rebuild on warm start"))
    eng2 = _engine(tmp_path, autotune_kwargs=kw)
    assert eng2.add_graph("g", w.a, w.params).warm_start
    assert eng2._graphs["g"].perm is not None
    assert np.array_equal(_np(eng2.infer("g", w.x)), ref)


def test_corrupted_store_entry_falls_back_to_retune(tmp_path):
    w = _workload(2)
    eng = _engine(tmp_path)
    eng.add_graph("g", w.a, w.params)
    ref = _np(eng.infer("g", w.x))
    st = TuningStore(tmp_path)
    (entry,) = st.entries()
    st.path(entry).write_bytes(b"not an npz at all")
    registry.clear_caches()
    eng2 = _engine(tmp_path)
    with pytest.warns(UserWarning, match="corrupted"):
        rep = eng2.add_graph("g", w.a, w.params)
    assert not rep.warm_start and eng2.counters["store_misses"] == 1
    np.testing.assert_allclose(_np(eng2.infer("g", w.x)), ref, atol=1e-5)
    assert st.entries()


def test_lru_eviction_respects_byte_budget(tmp_path, monkeypatch):
    graphs = {f"g{i}": _workload(10 + i) for i in range(3)}
    eng = _engine(tmp_path)
    refs = {}
    for gid, w in graphs.items():
        eng.add_graph(gid, w.a, w.params)
        refs[gid] = _np(eng.infer(gid, w.x))
    per_graph = max(r.bytes for r in eng._graphs.values())
    registry.clear_caches()
    budget = int(per_graph * 2.2)
    eng2 = _engine(tmp_path, device_budget_bytes=budget)
    for gid, w in graphs.items():
        eng2.add_graph(gid, w.a, w.params)
        assert eng2.device_bytes_in_use <= budget
    assert eng2.counters["evictions"] >= 1
    assert 1 <= len(eng2.resident_graphs) < 3
    victim = next(r for r in eng2._graphs.values() if r.executor is None)
    assert victim.params is None and victim.params_host is not None
    assert all(r.bytes > sum(w.nbytes for w in r.params_host.values())
               for r in eng2._graphs.values() if r.executor is not None)
    # re-admission re-uploads: no schedule rebuild
    monkeypatch.setattr(tsched, "build_balanced_schedule",
                        lambda *a_, **k: pytest.fail("rebuild on re-admit"))
    for gid, w in graphs.items():
        assert np.array_equal(_np(eng2.infer(gid, w.x)), refs[gid])
        assert eng2.device_bytes_in_use <= budget
    assert eng2.counters["readmissions"] >= 1
    assert eng2.stats()["n_resident"] == len(eng2.resident_graphs)


def test_budget_smaller_than_one_graph_keeps_active_resident(tmp_path):
    w = _workload(20)
    eng = _engine(tmp_path, device_budget_bytes=1)
    eng.add_graph("g", w.a, w.params)
    assert eng.resident_graphs == ["g"]
    np.testing.assert_allclose(_np(eng.infer("g", w.x)), _gold(w, w.x), atol=TOL)


def test_submit_flush_batches_per_graph(tmp_path):
    g1, g2 = _workload(30), _workload(31)
    eng = _engine(tmp_path)
    eng.add_graph("g1", g1.a, g1.params)
    eng.add_graph("g2", g2.a, g2.params)
    with pytest.raises(KeyError):
        eng.submit("nope", g1.x)
    eng.submit("g1", g1.x)
    eng.submit("g1", g1.x * 0.5)
    eng.submit("g2", g2.x)
    before = eng.counters["batches"]
    outs = eng.flush()
    assert eng.counters["batches"] == before + 2
    assert eng.counters["requests"] >= 3
    assert outs["g1"].shape == (2, N_NODES, N_CLASSES)
    assert outs["g2"].shape == (1, N_NODES, N_CLASSES)
    np.testing.assert_allclose(_np(outs["g1"][1]), _gold(g1, g1.x * 0.5), atol=TOL)
    assert eng.flush() == {}
    with pytest.raises(ValueError, match="must be"):
        eng.submit("g1", g1.x[:-1])


def test_flush_failure_preserves_unserved_queues(tmp_path, monkeypatch):
    g1, g2 = _workload(32), _workload(33)
    eng = _engine(tmp_path)
    eng.add_graph("g1", g1.a, g1.params)
    eng.add_graph("g2", g2.a, g2.params)
    eng.submit("g1", g1.x)
    eng.submit("g2", g2.x)
    orig = eng._dispatch_batch

    def failing(graph_id, xs):
        if graph_id == "g2":
            raise RuntimeError("device fell over")
        return orig(graph_id, xs)

    monkeypatch.setattr(eng, "_dispatch_batch", failing)
    monkeypatch.setattr(ge, "_sleep", lambda s: None)
    with pytest.raises(FlushError) as exc_info:
        eng.flush()
    err = exc_info.value
    assert err.partial["g1"].shape == (1, N_NODES, N_CLASSES)
    assert set(err.failures) == {"g2"}
    assert "g1" not in eng._pending and len(eng._pending["g2"]) == 1
    monkeypatch.undo()
    assert eng.flush()["g2"].shape == (1, N_NODES, N_CLASSES)


def test_cold_admission_does_not_pin_registry_caches(tmp_path):
    w = _workload(60)
    eng = _engine(tmp_path, autotune_kwargs=dict(FAST_KW, bf16_report=True))
    eng.add_graph("g", w.a, w.params)
    fp = registry.graph_fingerprint(w.a)
    for cache in (registry._EXECUTOR_CACHE, registry._SCHEDULE_CACHE):
        leaked = [k for k in cache if (k[0] if isinstance(k[0], str) else k[0][0]) == fp]
        assert leaked == []
    # the engine's own executor holds the only upload of the winner
    sched = eng._graphs["g"].sched
    assert [k for k in texe._DEVICE_STEPS if k[0] == id(sched)] == []
    np.testing.assert_allclose(_np(eng.infer("g", w.x)), _gold(w, w.x), atol=TOL)


def test_eviction_is_lru_not_insertion_order(tmp_path):
    graphs = {f"g{i}": _workload(70 + i) for i in range(3)}
    eng = _engine(tmp_path)
    for gid, w in graphs.items():
        eng.add_graph(gid, w.a, w.params)
    per_graph = max(r.bytes for r in eng._graphs.values())
    registry.clear_caches()
    eng2 = _engine(tmp_path, device_budget_bytes=int(per_graph * 2.2))
    eng2.add_graph("g0", graphs["g0"].a, graphs["g0"].params)
    eng2.add_graph("g1", graphs["g1"].a, graphs["g1"].params)
    eng2.infer("g0", graphs["g0"].x)
    eng2.add_graph("g2", graphs["g2"].a, graphs["g2"].params)
    assert "g1" not in eng2.resident_graphs
    assert "g0" in eng2.resident_graphs and "g2" in eng2.resident_graphs
    registry.clear_caches()
    eng3 = _engine(tmp_path, device_budget_bytes=int(per_graph * 2.2))
    eng3.add_graph("g0", graphs["g0"].a, graphs["g0"].params)
    eng3.add_graph("g1", graphs["g1"].a, graphs["g1"].params)
    eng3.infer("g1", graphs["g1"].x)
    eng3.infer("g0", graphs["g0"].x)
    eng3.add_graph("g2", graphs["g2"].a, graphs["g2"].params)
    assert "g1" not in eng3.resident_graphs and "g0" in eng3.resident_graphs


def test_direct_serve_batch_counts_only_completed(tmp_path, monkeypatch):
    w = _workload(80)
    eng = _engine(tmp_path)
    eng.add_graph("g", w.a, w.params)
    before = dict(eng.counters)

    def async_fault(out, event=None):
        raise RuntimeError("device OOM stand-in")

    monkeypatch.setattr(ge, "_block_until_ready", async_fault)
    with pytest.raises(RuntimeError, match="OOM"):
        eng.serve_batch("g", [w.x, w.x * 0.5])
    assert eng.counters["batches"] == before["batches"]
    assert eng.counters["requests"] == before["requests"]
    assert "g" not in eng._svc_ewma
    monkeypatch.undo()
    eng.serve_batch("g", [w.x, w.x * 0.5])
    assert eng.counters["batches"] == before["batches"] + 1
    assert eng.counters["requests"] == before["requests"] + 2
    assert eng._svc_ewma["g"] > 0.0
    before = dict(eng.counters)
    monkeypatch.setattr(eng, "_dispatch_batch",
                        lambda *a_, **k: (_ for _ in ()).throw(RuntimeError("bad dispatch")))
    monkeypatch.setattr(ge, "_sleep", lambda s: None)
    with pytest.raises(RuntimeError, match="bad dispatch"):
        eng.serve_batch("g", [w.x])
    assert eng.counters["batches"] == before["batches"]
    assert eng.counters["requests"] == before["requests"]


def test_async_failure_in_flush_keeps_counters_honest(tmp_path, monkeypatch):
    w = _workload(81)
    eng = _engine(tmp_path)
    eng.add_graph("g", w.a, w.params)
    eng.submit("g", w.x)
    before = dict(eng.counters)
    monkeypatch.setattr(ge, "_block_until_ready",
                        lambda out, event=None: (_ for _ in ()).throw(
                            RuntimeError("async fault")))
    with pytest.raises(FlushError):
        eng.flush()
    assert eng.counters["batches"] == before["batches"]
    assert eng.counters["requests"] == before["requests"]
    assert len(eng._pending["g"]) == 1
    monkeypatch.undo()
    assert eng.flush()["g"].shape == (1, N_NODES, N_CLASSES)
    assert eng.counters["batches"] == before["batches"] + 1


def test_remove_graph_releases_budget(tmp_path):
    w = _workload(40)
    eng = _engine(tmp_path)
    eng.add_graph("g", w.a, w.params)
    assert eng.device_bytes_in_use > 0
    eng.remove_graph("g")
    assert eng.device_bytes_in_use == 0 and eng.graphs == []
    with pytest.raises(KeyError):
        eng.infer("g", w.x)


def test_remove_graph_fails_queued_requests_once(tmp_path):
    w = _workload(41)
    eng = _engine(tmp_path)
    eng.add_graph("g", w.a, w.params)
    eng.submit("g", w.x)
    eng.submit("g", w.x * 2)
    with pytest.raises(RequestFailure) as ei:
        eng.remove_graph("g")
    assert ei.value.n_failed == 2
    st = _identity(eng)
    assert st["dropped"] == 2 and st["pending_requests"] == 0
    assert eng.device_bytes_in_use == 0


def test_wrong_feature_rows_rejected(tmp_path):
    w = _workload(50)
    eng = _engine(tmp_path)
    eng.add_graph("g", w.a, w.params)
    with pytest.raises(ValueError, match="nodes"):
        eng.serve_batch("g", [w.x[:-1]])


# ---------------------------------------------------------------------------
# Admission control under overload (tests/test_overload.py)
# ---------------------------------------------------------------------------


def test_submit_tickets_and_reject_at_max_queue_depth(tmp_path):
    w = _workload(0)
    eng = _engine(tmp_path, max_queue_depth=2)
    eng.add_graph("g", w.a, w.params)
    t1 = eng.submit("g", w.x)
    t2 = eng.submit("g", w.x * 0.5)
    assert isinstance(t1, SubmitTicket)
    assert t1.status == ACCEPTED and t1.accepted and bool(t1)
    assert t1.rid is not None and t2.rid == t1.rid + 1
    t3 = eng.submit("g", w.x)
    assert t3.status == REJECTED and not t3.accepted and not t3
    assert t3.rid is None and "max_queue_depth" in t3.reason
    st = _identity(eng)
    assert st["submitted"] == 3 and st["rejected"] == 1 and st["pending_requests"] == 2
    assert eng.flush()["g"].shape == (2, N_NODES, N_CLASSES)
    st = _identity(eng)
    assert st["queue_served"] == 2 and st["pending_requests"] == 0


def test_ctor_validates_knobs(tmp_path):
    for kw, match in [(dict(max_queue_depth=0), "max_queue_depth"),
                      (dict(max_dispatch_retries=-1), "max_dispatch_retries"),
                      (dict(max_batch=0), "max_batch"),
                      (dict(max_replicas=0), "max_replicas"),
                      (dict(repair_drift_threshold=0.0), "repair_drift_threshold"),
                      (dict(autotune_kwargs={"store": None}), "may not override"),
                      (dict(autotune_kwargs={"device": "cpu"}), "may not override"),
                      (dict(devices=0), "devices=0")]:
        with pytest.raises(ValueError, match=match):
            _engine(tmp_path, **kw)


def test_shed_iff_predicted_wait_exceeds_deadline(tmp_path):
    w = _workload(1)
    eng = _engine(tmp_path, shed_unmeetable=True)
    eng.add_graph("g", w.a, w.params)
    eng._svc_ewma["g"] = 1.0
    eng._svc_req_ewma["g"] = 1.0 / 8
    now = 1000.0
    t = eng.submit("g", w.x, deadline_s=0.5, now=now)
    assert t.status == SHED and not t and t.rid is None
    assert "predicted wait" in t.reason
    assert eng.submit("g", w.x, deadline_s=1.5, now=now).status == ACCEPTED
    assert eng.submit("g", w.x, now=now).status == ACCEPTED
    st = _identity(eng)
    assert st["shed"] == 1 and st["pending_requests"] == 2


def test_shed_accumulates_edf_ahead_queues(tmp_path):
    g1, g2 = _workload(2), _workload(3)
    eng = _engine(tmp_path, shed_unmeetable=True)
    eng.add_graph("g1", g1.a, g1.params)
    eng.add_graph("g2", g2.a, g2.params)
    now = 1000.0
    assert eng.submit("g1", g1.x, deadline_s=0.5, now=now).accepted
    for gid in ("g1", "g2"):
        eng._svc_ewma[gid] = 1.0
        eng._svc_req_ewma[gid] = 1.0 / 8
    assert eng.submit("g2", g2.x, deadline_s=1.5, now=now).status == SHED
    assert eng.submit("g2", g2.x, deadline_s=2.5, now=now).accepted
    eng._pending.pop("g1")
    assert eng.submit("g2", g2.x, deadline_s=1.5, now=now).accepted
    assert eng.counters["shed"] == 1


def test_reject_takes_precedence_over_shed(tmp_path):
    w = _workload(4)
    eng = _engine(tmp_path, max_queue_depth=1, shed_unmeetable=True)
    eng.add_graph("g", w.a, w.params)
    eng._svc_ewma["g"] = 1.0
    now = 1000.0
    assert eng.submit("g", w.x, deadline_s=10.0, now=now).accepted
    assert eng.submit("g", w.x, deadline_s=0.1, now=now).status == REJECTED
    assert eng.counters["rejected"] == 1 and eng.counters["shed"] == 0


def test_dispatch_time_shed_on_stale_queue(tmp_path):
    w = _workload(5)
    eng = _engine(tmp_path, shed_unmeetable=True)
    eng.add_graph("g", w.a, w.params)
    now = 1000.0
    assert eng.submit("g", w.x, deadline_s=0.05, now=now).accepted
    assert eng.poll(now=now + 0.2) == {}
    st = _identity(eng)
    assert st["shed"] == 1 and st["pending_requests"] == 0
    assert st["queue_served"] == 0 and st["batches"] == 0


def test_overload_accounting_identity_mixed_outcomes(tmp_path):
    g1, g2 = _workload(6), _workload(7)
    eng = _engine(tmp_path, max_queue_depth=2, shed_unmeetable=True)
    eng.add_graph("g1", g1.a, g1.params)
    eng.add_graph("g2", g2.a, g2.params)
    now = 1000.0
    assert eng.submit("g1", g1.x, deadline_s=50.0, now=now).accepted
    assert eng.submit("g1", g1.x * 0.5, deadline_s=50.0, now=now).accepted
    assert eng.submit("g1", g1.x, deadline_s=50.0, now=now).status == REJECTED
    assert eng.submit("g2", g2.x, deadline_s=0.01, now=now).accepted
    _identity(eng)
    assert eng.poll(now=now + 0.5) == {}
    st = _identity(eng)
    assert st["shed"] == 1 and st["rejected"] == 1 and st["pending_requests"] == 2
    eng.shed_unmeetable = False
    assert eng.flush()["g1"].shape == (2, N_NODES, N_CLASSES)
    st = _identity(eng)
    assert st["submitted"] == 4 and st["queue_served"] == 2
    assert st["pending_requests"] == 0


def test_threshold_autoflush_counts_queue_served(tmp_path):
    w = _workload(8)
    eng = _engine(tmp_path, max_batch=2)
    eng.add_graph("g", w.a, w.params)
    assert eng.submit("g", w.x).accepted
    assert eng.submit("g", w.x * 0.5).accepted
    st = _identity(eng)
    assert st["queue_served"] == 2 and st["pending_requests"] == 0
    assert eng.poll()["g"].shape == (2, N_NODES, N_CLASSES)


def test_unknown_graph_error_unified_across_paths(tmp_path):
    eng = _engine(tmp_path)
    x = np.zeros((4, 4), np.float32)
    for op, call in [("submit", lambda: eng.submit("nope", x)),
                     ("serve", lambda: eng.serve_batch("nope", [x])),
                     ("serve", lambda: eng.infer("nope", x)),
                     ("remove_graph", lambda: eng.remove_graph("nope"))]:
        with pytest.raises(UnknownGraphError) as ei:
            call()
        assert isinstance(ei.value, KeyError)
        assert ei.value.graph_id == "nope" and ei.value.op == op


def test_stats_backpressure_surface(tmp_path):
    w = _workload(9)
    eng = _engine(tmp_path)
    eng.add_graph("g", w.a, w.params)
    eng.submit("g", w.x)
    eng._svc_ewma["g"] = 0.5
    st = eng.stats()
    assert st["queue_depth"] == {"g": 1}
    assert st["saturation_s"][0] == pytest.approx(0.5)
    assert all("saturation_s" in row for row in st["per_device"])
    assert st["latency_us_p50"] == 0.0 and st["latency_n"] == 0
    eng.flush()
    for _ in range(3):
        eng.submit("g", w.x)
    eng.flush()
    st = eng.stats()
    assert st["queue_depth"] == {} and st["saturation_s"][0] < 0.5
    assert st["latency_n"] == 4
    assert 0.0 < st["latency_us_p50"] <= st["latency_us_p95"] <= st["latency_us_p99"]
    assert st["replicas"] == {} and st["n_devices"] == 1
    _identity(eng)


def test_reset_stats_clears_latency_reservoir(tmp_path):
    w = _workload(10)
    eng = _engine(tmp_path)
    eng.add_graph("g", w.a, w.params)
    eng.submit("g", w.x)
    eng.flush()
    assert eng.stats()["latency_us_p50"] > 0.0
    eng.reset_stats()
    st = eng.stats()
    assert st["latency_us_p50"] == 0.0 and st["latency_n"] == 0 and st["submitted"] == 0
    _identity(eng)


# ---------------------------------------------------------------------------
# Deadline-aware serving (single-device cases of tests/test_placement.py)
# ---------------------------------------------------------------------------


def test_poll_serves_due_deadline_bit_identical_to_serve_batch(tmp_path):
    w = _workload(0)
    eng = _engine(tmp_path)
    eng.add_graph("g", w.a, w.params)
    xs = [w.x, w.x * 0.5, w.x + 0.1]
    for xi in xs:
        eng.submit("g", xi, deadline_s=60.0)
    assert eng.poll() == {}
    assert eng.stats()["pending_requests"] == 3
    out = eng.poll(now=time.monotonic() + 61.0)
    assert set(out) == {"g"} and out["g"].shape == (3, N_NODES, N_CLASSES)
    assert torch.equal(out["g"], eng.serve_batch("g", xs))
    st = eng.stats()
    assert st["deadline_met"] == 3 and st["deadline_misses"] == 0
    assert st["latency_us_mean"] > 0 and st["pending_requests"] == 0


def test_service_time_estimate_dispatches_before_deadline(tmp_path):
    w = _workload(1)
    eng = _engine(tmp_path)
    eng.add_graph("g", w.a, w.params)
    eng.submit("g", w.x, deadline_s=60.0)
    now = time.monotonic()
    assert eng.poll(now=now) == {}
    eng._svc_ewma["g"] = 61.0
    assert set(eng.poll(now=now)) == {"g"}


def test_past_deadline_records_miss(tmp_path):
    w = _workload(2)
    eng = _engine(tmp_path)
    eng.add_graph("g", w.a, w.params)
    eng.submit("g", w.x, deadline_s=-1.0)
    assert set(eng.poll()) == {"g"}
    assert eng.stats()["deadline_misses"] == 1 and eng.stats()["deadline_met"] == 0


def test_max_batch_threshold_auto_flushes(tmp_path):
    w = _workload(3)
    eng = _engine(tmp_path, max_batch=2)
    eng.add_graph("g", w.a, w.params)
    eng.submit("g", w.x)
    assert eng.stats()["pending_requests"] == 1
    eng.submit("g", w.x * 0.5)
    assert eng.stats()["pending_requests"] == 0 and eng.counters["batches"] == 1
    out = eng.flush()
    assert out["g"].shape == (2, N_NODES, N_CLASSES)
    np.testing.assert_allclose(_np(out["g"][1]), _gold(w, w.x * 0.5), atol=TOL)


def test_flush_order_is_edf_then_graph_id_not_insertion(tmp_path):
    graphs = {f"g{i}": _workload(10 + i) for i in range(3)}
    eng = _engine(tmp_path)
    for gid, w in graphs.items():
        eng.add_graph(gid, w.a, w.params)
    eng.submit("g2", graphs["g2"].x)
    eng.submit("g0", graphs["g0"].x, deadline_s=500.0)
    eng.submit("g1", graphs["g1"].x, deadline_s=100.0)
    order = []
    orig = eng._dispatch_batch

    def recording(graph_id, xs):
        order.append(graph_id)
        return orig(graph_id, xs)

    eng._dispatch_batch = recording
    eng.flush()
    assert order == ["g1", "g0", "g2"]


def test_flush_restores_multiple_failed_queues_in_order(tmp_path, monkeypatch):
    graphs = {f"g{i}": _workload(20 + i) for i in range(3)}
    eng = _engine(tmp_path)
    for gid, w in graphs.items():
        eng.add_graph(gid, w.a, w.params)
    for gid, w in graphs.items():
        eng.submit(gid, w.x)
        eng.submit(gid, w.x * 2.0)
    orig = eng._dispatch_batch

    def failing(graph_id, xs):
        if graph_id in ("g0", "g2"):
            raise RuntimeError(f"{graph_id} device fell over")
        return orig(graph_id, xs)

    eng._dispatch_batch = failing
    monkeypatch.setattr(ge, "_sleep", lambda s: None)
    with pytest.raises(FlushError) as exc_info:
        eng.flush()
    err = exc_info.value
    assert set(err.failures) == {"g0", "g2"} and set(err.partial) == {"g1"}
    assert err.partial["g1"].shape == (2, N_NODES, N_CLASSES)
    for gid in ("g0", "g2"):
        q = eng._pending[gid]
        assert len(q) == 2
        assert np.array_equal(_np(q[0].x), graphs[gid].x)
        assert np.array_equal(_np(q[1].x), graphs[gid].x * 2.0)
    assert "g1" not in eng._pending
    eng._dispatch_batch = orig
    out = eng.flush()
    assert set(out) == {"g0", "g2"}
    assert all(v.shape == (2, N_NODES, N_CLASSES) for v in out.values())


def test_restored_queue_front_ordering_with_new_submissions(tmp_path, monkeypatch):
    w = _workload(30)
    eng = _engine(tmp_path)
    eng.add_graph("g", w.a, w.params)
    eng.submit("g", w.x)
    orig = eng._dispatch_batch
    eng._dispatch_batch = lambda *a_, **k: (_ for _ in ()).throw(RuntimeError("boom"))
    monkeypatch.setattr(ge, "_sleep", lambda s: None)
    with pytest.raises(FlushError):
        eng.flush()
    eng._dispatch_batch = orig
    eng.submit("g", w.x * 3.0)
    q = eng._pending["g"]
    assert np.array_equal(_np(q[0].x), w.x) and np.array_equal(_np(q[1].x), w.x * 3.0)
    assert eng.flush()["g"].shape == (2, N_NODES, N_CLASSES)


def _load_map_engine(tmp_path, placements):
    eng = ge.GCNServingEngine(store_root=tmp_path, device="cpu")
    eng.placer = MeshPlacer(2, 1 << 30)
    eng.placer.placements.update(placements)
    eng._serve_queues = lambda gids, now=None: {g: None for g in gids}
    return eng


def _queue(eng, gid, deadline):
    eng._pending.setdefault(gid, []).append(
        ge._Request(rid=0, x=None, submit_t=0.0, deadline=deadline))


def test_poll_load_map_stacks_colocated_queues(tmp_path):
    eng = _load_map_engine(tmp_path, {"a": Placement(SINGLE, 0, 1),
                                      "b": Placement(SINGLE, 0, 1)})
    eng._svc_ewma.update(a=10.0, b=10.0)
    _queue(eng, "a", deadline=1000.0)
    _queue(eng, "b", deadline=1001.0)
    assert eng.poll(now=969.0) == {}
    assert set(eng.poll(now=975.0)) == {"a", "b"}


def test_poll_load_map_keeps_devices_independent(tmp_path):
    eng = _load_map_engine(tmp_path, {"a": Placement(SINGLE, 0, 1),
                                      "b": Placement(SINGLE, 1, 1)})
    eng._svc_ewma.update(a=10.0, b=10.0)
    _queue(eng, "a", deadline=1000.0)
    _queue(eng, "b", deadline=1001.0)
    assert eng.poll(now=975.0) == {}
    assert set(eng.poll(now=985.5)) == {"a"}


def test_poll_load_map_sharded_occupies_every_device(tmp_path):
    eng = _load_map_engine(tmp_path, {"s": Placement(SHARDED, None, 2),
                                      "b": Placement(SINGLE, 1, 1)})
    eng._svc_ewma.update(s=10.0, b=10.0)
    _queue(eng, "s", deadline=1000.0)
    _queue(eng, "b", deadline=1001.0)
    assert set(eng.poll(now=975.0)) == {"s", "b"}


def test_poll_load_map_replicated_follows_least_loaded_replica(tmp_path):
    eng = _load_map_engine(tmp_path, {"busy": Placement(SINGLE, 0, 1),
                                      "hot": Placement(REPLICATED, 0, 1, (0, 1))})
    eng._svc_ewma.update(busy=50.0, hot=10.0)
    _queue(eng, "busy", deadline=1000.0)
    _queue(eng, "hot", deadline=1100.0)
    assert set(eng.poll(now=1020.0)) == {"busy"}
    assert set(eng.poll(now=1090.0)) == {"busy", "hot"}


def test_placement_survives_restart_warm_start(tmp_path):
    graphs = {f"g{i}": _workload(40 + i) for i in range(2)}
    eng = _engine(tmp_path)
    refs = {}
    for gid, w in graphs.items():
        rep = eng.add_graph(gid, w.a, w.params)
        assert not rep.warm_start and rep.placement.kind == SINGLE
        refs[gid] = _np(eng.infer(gid, w.x))
    registry.clear_caches()
    eng2 = _engine(tmp_path)
    for gid, w in graphs.items():
        rep = eng2.add_graph(gid, w.a, w.params)
        assert rep.warm_start and rep.tune_seconds == 0.0
        assert rep.placement.kind == SINGLE
    assert eng2.counters["store_hits"] == 2 and eng2.counters["store_misses"] == 0
    for gid, w in graphs.items():
        eng2.submit(gid, w.x, deadline_s=0.0)
    out = eng2.poll()
    assert set(out) == set(graphs)
    for gid in graphs:
        np.testing.assert_allclose(_np(out[gid][0]), refs[gid], atol=1e-5)


def test_single_device_engine_serves_on_its_device(tmp_path):
    w = _workload(50)
    eng = _engine(tmp_path)
    eng.add_graph("g", w.a, w.params)
    assert eng.devices == [torch.device("cpu")]
    assert eng._graphs["g"].executor.device == torch.device("cpu")
    assert eng.infer("g", w.x).device == torch.device("cpu")


# ---------------------------------------------------------------------------
# The copy-free batch: each request reaches X·W from the tensor it came as
# ---------------------------------------------------------------------------

ONE_CANDIDATE = dict(FAST_KW, sweep=FAST_SWEEP[:1])


def _forbid_stack_in_dispatch(eng, monkeypatch):
    """Make ``torch.stack`` and ``torch.cat`` raise while ``eng`` dispatches
    a batch; returns the graph ids of the dispatches seen."""
    inside, seen = [], []
    dispatch = eng._dispatch_batch

    def watched(graph_id, xs):
        inside.append(graph_id)
        seen.append(graph_id)
        try:
            return dispatch(graph_id, xs)
        finally:
            inside.pop()

    def forbid(name, fn):
        def f(*a, **k):
            if inside:
                pytest.fail(f"torch.{name} on the dispatch path")
            return fn(*a, **k)
        return f

    monkeypatch.setattr(eng, "_dispatch_batch", watched)
    monkeypatch.setattr(torch, "stack", forbid("stack", torch.stack))
    monkeypatch.setattr(torch, "cat", forbid("cat", torch.cat))
    return seen


@pytest.mark.parametrize("path", ["serve_batch", "flush", "auto_flush"])
def test_a_batch_reaches_x_w_with_no_stack_or_cat(tmp_path, monkeypatch, path):
    w = _workload(60)
    eng = _engine(tmp_path, max_batch=2 if path == "auto_flush" else 32)
    eng.add_graph("g", w.a, w.params)
    xs = [torch.from_numpy(w.x), torch.from_numpy(w.x * 0.5)]
    ref = eng.serve_batch("g", torch.stack(xs))
    seen = _forbid_stack_in_dispatch(eng, monkeypatch)
    reads, matmul = [], torch.matmul

    def xw(a, b, **k):
        reads.append(a.data_ptr())
        return matmul(a, b, **k)

    monkeypatch.setattr(torch, "matmul", xw)
    if path == "serve_batch":
        out = eng.serve_batch("g", xs)
    else:
        for x in xs:
            assert eng.submit("g", x).accepted
        out = eng.flush()["g"]
    assert seen == ["g"] and torch.equal(out, ref)
    # the first layer's X·W read each request where it lies
    assert reads[:2] == [x.data_ptr() for x in xs]
    assert eng.counters["dispatch_retries"] == 0
    assert eng.stats()["requests_copied"] == 0


@pytest.mark.parametrize("path", ["serve_batch", "flush"])
def test_a_batch_of_mixed_shapes_raises_value_error_and_launches_nothing(
        tmp_path, monkeypatch, path):
    w = _workload(61)
    eng = _engine(tmp_path)
    eng.add_graph("g", w.a, w.params)
    monkeypatch.setattr(ge, "_sleep", lambda s: pytest.fail("backoff on a caller bug"))
    monkeypatch.setattr(texe.ScheduleExecutor, "forward_batch",
                        lambda *a: pytest.fail("a mismatched batch was launched"))
    narrow = np.random.default_rng(1).random((N_NODES, N_FEATS - 1)).astype(np.float32)
    if path == "serve_batch":
        with pytest.raises(ValueError, match=r"one \[n, f\] shape"):
            eng.serve_batch("g", [w.x, narrow])
    else:
        assert eng.submit("g", w.x).accepted and eng.submit("g", narrow).accepted
        with pytest.raises(FlushError) as ei:
            eng.flush()
        assert isinstance(ei.value.failures["g"], ValueError)
        assert [r.x.shape[1] for r in eng._pending["g"]] == [N_FEATS, N_FEATS - 1]
    assert eng.counters["dispatch_retries"] == 0 and eng.counters["batches"] == 0
    _outstanding_settled(eng)


def test_replicated_batches_and_sibling_retries_give_the_unreplicated_logits(
        tmp_path, monkeypatch):
    w = _workload(62)
    reqs = [torch.from_numpy(w.x * (1.0 - 0.05 * i)) for i in range(6)]
    one = _engine(tmp_path, autotune_kwargs=ONE_CANDIDATE)
    one.add_graph("g", w.a, w.params)
    ref = one.serve_batch("g", reqs)
    eng = ge.GCNServingEngine(store_root=tmp_path, devices=["cpu"] * 3, max_replicas=3,
                              replicate_after_s=1e-6, replica_shrink_after=10**6,
                              autotune_kwargs=ONE_CANDIDATE)
    eng.add_graph("g", w.a, w.params)
    assert torch.equal(eng.serve_batch("g", reqs), ref)
    for _ in range(3):
        for r in reqs:
            eng.submit("g", r, deadline_s=0.0)
        assert torch.equal(eng.poll()["g"], ref)
    pl = eng.placer.placement_of("g")
    assert pl.kind == REPLICATED and len(pl.device_indices) == 3, pl
    seen = _forbid_stack_in_dispatch(eng, monkeypatch)
    assert torch.equal(eng.serve_batch("g", reqs), ref)
    victim = sorted(eng._graphs["g"].replicas)[0]
    FAULTS.arm("replica_chunk", graph="g", device=victim, times=1)
    assert torch.equal(eng.serve_batch("g", reqs), ref)
    assert FAULTS.fired == [("replica_chunk", "g", victim)]
    assert eng.counters["chunk_retries"] == 1 and seen == ["g", "g"]
    assert eng.stats()["requests_copied"] == 0
    _outstanding_settled(eng)


def test_requests_copied_is_zero_for_requests_on_the_engine_device(tmp_path):
    w = _workload(63)
    eng = _engine(tmp_path, max_batch=2)
    eng.add_graph("g", w.a, w.params)
    eng.serve_batch("g", [w.x, torch.from_numpy(w.x)])  # host arrays: the CPU's own
    eng.serve_batch("g", torch.from_numpy(np.stack([w.x, w.x])))
    eng.infer("g", w.x)
    eng.submit("g", w.x)
    eng.submit("g", w.x * 0.5)
    assert eng.counters["requests"] == 7
    assert eng.stats()["requests_copied"] == 0


# ---------------------------------------------------------------------------
# The dispatch retry loop (single-device cases of tests/test_faults.py)
# ---------------------------------------------------------------------------


def test_transient_dispatch_fault_retries_and_recovers(tmp_path, monkeypatch):
    w = _workload(0)
    eng = _engine(tmp_path)
    eng.add_graph("g", w.a, w.params)
    ref = eng.serve_batch("g", [w.x])
    delays = []
    monkeypatch.setattr(ge, "_sleep", delays.append)
    FAULTS.arm("dispatch", times=1, graph="g")
    assert torch.equal(eng.serve_batch("g", [w.x]), ref)
    assert delays == [eng.retry_backoff_s]
    assert eng.counters["dispatch_retries"] == 1
    assert FAULTS.fired == [("dispatch", "g", None)]
    _outstanding_settled(eng)


def test_persistent_dispatch_fault_bounded_backoff_then_raises(tmp_path, monkeypatch):
    w = _workload(1)
    eng = _engine(tmp_path, max_dispatch_retries=2, retry_backoff_s=0.01)
    eng.add_graph("g", w.a, w.params)
    eng.serve_batch("g", [w.x])
    before = dict(eng.counters)
    delays = []
    monkeypatch.setattr(ge, "_sleep", delays.append)
    FAULTS.arm("dispatch", times=99, graph="g")
    with pytest.raises(InjectedFault):
        eng.serve_batch("g", [w.x])
    assert delays == [0.01, 0.02]
    assert len(FAULTS.fired) == 3
    assert eng.counters["dispatch_retries"] == before["dispatch_retries"] + 2
    assert eng.counters["batches"] == before["batches"]
    _outstanding_settled(eng)
    FAULTS.clear()
    assert torch.equal(eng.serve_batch("g", [w.x]), eng.serve_batch("g", [w.x]))


def test_validation_errors_never_burn_retries(tmp_path, monkeypatch):
    w = _workload(2)
    eng = _engine(tmp_path)
    eng.add_graph("g", w.a, w.params)
    monkeypatch.setattr(ge, "_sleep", lambda s: pytest.fail("backoff on a caller bug"))
    with pytest.raises(ValueError, match="nodes"):
        eng.serve_batch("g", [w.x[:-1]])
    assert eng.counters["dispatch_retries"] == 0


def test_queue_dispatch_fault_flusherror_restores_then_recovers(tmp_path, monkeypatch):
    w = _workload(3)
    eng = _engine(tmp_path)
    eng.add_graph("g", w.a, w.params)
    ref = eng.serve_batch("g", [w.x, w.x * 0.5])
    eng.submit("g", w.x)
    eng.submit("g", w.x * 0.5)
    monkeypatch.setattr(ge, "_sleep", lambda s: None)
    FAULTS.arm("dispatch", times=99, graph="g")
    with pytest.raises(FlushError) as ei:
        eng.flush()
    assert set(ei.value.failures) == {"g"} and len(eng._pending["g"]) == 2
    _identity(eng)
    _outstanding_settled(eng)
    FAULTS.clear()
    assert torch.equal(eng.flush()["g"], ref)
    st = eng.stats()
    assert st["queue_served"] == 2 and st["pending_requests"] == 0


def test_upload_fault_on_readmission_recovers_via_retry(tmp_path, monkeypatch):
    g0, g1 = _workload(4), _workload(5)
    eng = _engine(tmp_path)
    eng.add_graph("g0", g0.a, g0.params)
    eng.add_graph("g1", g1.a, g1.params)
    per = max(r.bytes for r in eng._graphs.values())
    ref0 = _np(eng.infer("g0", g0.x))
    registry.clear_caches()
    eng2 = _engine(tmp_path, device_budget_bytes=int(per * 1.2))
    eng2.add_graph("g0", g0.a, g0.params)
    eng2.add_graph("g1", g1.a, g1.params)
    assert "g0" not in eng2.resident_graphs
    monkeypatch.setattr(ge, "_sleep", lambda s: None)
    FAULTS.arm("upload", times=1)
    np.testing.assert_allclose(_np(eng2.infer("g0", g0.x)), ref0, atol=1e-5)
    assert eng2.counters["dispatch_retries"] == 1
    assert eng2.counters["readmissions"] >= 1
    assert FAULTS.fired and FAULTS.fired[0][0] == "upload"
    _outstanding_settled(eng2)


def test_await_failure_rolls_back_and_surfaces_per_request(tmp_path, monkeypatch):
    w = _workload(6)
    eng = _engine(tmp_path)
    eng.add_graph("g", w.a, w.params)
    eng.serve_batch("g", [w.x])
    assert eng._svc_req_ewma["g"] > 0
    r1 = eng.submit("g", w.x)
    r2 = eng.submit("g", w.x * 0.5)
    before = dict(eng.counters)
    monkeypatch.setattr(ge, "_block_until_ready",
                        lambda out, event=None: (_ for _ in ()).throw(
                            RuntimeError("async device fault")))
    with pytest.raises(FlushError):
        eng.flush()
    _outstanding_settled(eng)
    assert [r.rid for r in eng._pending["g"]] == [r1.rid, r2.rid]
    assert eng.counters["request_failures"] == before["request_failures"] + 2
    assert eng.counters["batches"] == before["batches"]
    monkeypatch.undo()
    assert eng.flush()["g"].shape == (2, N_NODES, N_CLASSES)
    _outstanding_settled(eng)


def test_direct_path_raises_typed_request_failure(tmp_path, monkeypatch):
    w = _workload(7)
    eng = _engine(tmp_path)
    eng.add_graph("g", w.a, w.params)
    eng.serve_batch("g", [w.x])
    before = dict(eng.counters)
    cause = RuntimeError("async device fault")
    monkeypatch.setattr(ge, "_block_until_ready",
                        lambda out, event=None: (_ for _ in ()).throw(cause))
    with pytest.raises(RequestFailure) as ei:
        eng.serve_batch("g", [w.x, w.x * 0.5])
    e = ei.value
    assert isinstance(e, RuntimeError) and e.graph_id == "g" and e.n_failed == 2
    assert e.cause is cause and e.partial is None
    assert eng.counters["request_failures"] == before["request_failures"] + 2
    assert eng.counters["batches"] == before["batches"]


# ---------------------------------------------------------------------------
# The port's own surface: policy seam, part 2, the card by default
# ---------------------------------------------------------------------------


def test_engine_policy_constructor_seam(tmp_path):
    w = _workload(11)
    assert type(_engine(tmp_path).policy).__name__ == "HeuristicPolicy"
    pol = LearnedServiceTimePolicy(min_samples=2)
    eng = _engine(tmp_path, policy=pol)
    assert eng.policy is pol
    eng.add_graph("g", w.a, w.params)
    for _ in range(3):
        eng.serve_batch("g", [w.x, w.x])
    assert pol.fitted and pol.prediction_report()["n_samples"] == 3


def test_part_2_raises_not_implemented(tmp_path):
    """Part 2 (the mesh) is in place: a list of devices builds a mesh engine
    (several positions may name one device), and what still raises is
    validation — ``devices`` beside ``device``, more devices than the host
    exposes, an empty mesh, and a sharded candidate on the single-device
    route. No ``NotImplementedError`` is left."""
    w = _workload(12)
    eng = _engine(tmp_path)
    eng.add_graph("g", w.a, w.params)
    two = ge.GCNServingEngine(store_root=tmp_path, devices=["cpu", "cpu"],
                              autotune_kwargs=FAST_KW)
    assert two.devices == [torch.device("cpu")] * 2 and two.n_devices == 2
    assert two.max_replicas == 2 and two._mesh == two.devices
    rep = two.add_graph("g", w.a, w.params)
    assert rep.placement.kind == SINGLE and rep.warm_start
    np.testing.assert_array_equal(_np(two.infer("g", w.x)), _np(eng.infer("g", w.x)))
    one = ge.GCNServingEngine(store_root=tmp_path, devices=["cpu"])
    assert one.devices == [torch.device("cpu")] and one.n_devices == 1
    assert one._mesh is None
    assert ge.GCNServingEngine(store_root=tmp_path, devices=1,
                               device="cpu").n_devices == 1
    with pytest.raises(ValueError, match="not both"):
        ge.GCNServingEngine(store_root=tmp_path, devices=["cpu"], device="cpu")
    with pytest.raises(ValueError, match="exposes 1 device"):
        ge.GCNServingEngine(store_root=tmp_path, devices=2, device="cpu")
    with pytest.raises(ValueError, match="no device"):
        ge.GCNServingEngine(store_root=tmp_path, devices=[])
    bad = dict(FAST_KW, sweep=[dict(FAST_SWEEP[0], n_devices=2)])
    with pytest.raises(ValueError, match="device"):
        _engine(tmp_path / "s", autotune_kwargs=bad).add_graph("s", w.a, w.params)


def test_engine_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ge.GCNServingEngine(store_root=tmp_path)


def test_serving_package_public_api():
    import repro.serving as jserving
    import repro_torch.serving as serving

    assert set(serving.__all__) == set(jserving.__all__)
    for name in serving.__all__:
        assert getattr(serving, name) is not None
    assert serving.GCNServingEngine is ge.GCNServingEngine
    assert ge.UnknownGraphError is UnknownGraphError
    from repro_torch.models.transformer_serve import ServeEngine
    from repro_torch.serving.engine import ServeEngine as old_path

    assert old_path is ServeEngine
