"""The port's ``GCNServingEngine`` on a mesh (part 2), decision for decision
against the reference engine on 8 forced host devices.

Each scenario below is one function of a package namespace ``P``: the
reference's subprocess runs it on ``repro`` with ``devices=8`` (as its own
tests do), and the port's test runs it on ``repro_torch`` with
``devices=["cpu"] * 8``. Both runs check the reference tests' assertions on
themselves and record their placements, counters and decisions; the port's
must equal the reference's, and their logits agree within 2e-4. Replicated
outputs are ``np.array_equal`` to a ``max_replicas=1`` engine's within each
package. Mirrors the multi-device cases of ``tests/test_placement.py``
(``SCRIPT_MESH``, ``SCRIPT_REPLICA``), ``tests/test_faults.py``'s
``SCRIPT_REPLICA_FAULTS``, ``tests/test_streaming.py``'s ``SCRIPT_STREAM``
and ``tests/test_reorder.py``'s sharded round trip."""
import json
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = str(Path(__file__).resolve().parents[1] / "src")
TOL = 2e-4
SWEEP = [dict(nnz_per_step=64, rows_per_window=32, cols_per_block=None,
              window_nnz=None, routing="gather")]
KW = dict(iters=1, warmup=1, sweep=SWEEP, bf16_report=False)


def _glorot(seed, dims=(16, 16, 4)):
    rng = np.random.default_rng(seed)
    out = {}
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        lim = np.sqrt(6.0 / (din + dout))
        out[f"w{i}"] = rng.uniform(-lim, lim, (din, dout)).astype(np.float32)
    return out


def _x(n, seed):
    return np.random.default_rng(seed).random((n, 16)).astype(np.float32)


def reference_pkg():
    """The namespace of the JAX package (the subprocess's)."""
    import jax
    import jax.numpy as jnp

    from repro.core import csc, executor, gcn, schedule
    from repro.graphs import synth
    from repro.serving import gcn_engine, placement
    from repro.tuning import registry, runner

    return types.SimpleNamespace(
        csc=csc, exe=executor, schedule=schedule, synth=synth, ge=gcn_engine,
        placement=placement, registry=registry, runner=runner,
        mesh=lambda n: n, one={},
        gold=lambda p, a, x: np.asarray(gcn.forward(p, a, jnp.asarray(x))),
        device_of=lambda out: list(out.devices())[0],
        unit_out=lambda u, x: np.asarray(u.fwd(u.params, jnp.asarray(x[None]))[0]),
        primary=lambda eng: jax.devices()[0],
    )


def port_pkg():
    """The namespace of the port, on a mesh of host positions."""
    from repro_torch.core import csc, executor, gcn, schedule
    from repro_torch.graphs import synth
    from repro_torch.serving import gcn_engine, placement
    from repro_torch.tuning import registry, runner

    def gold(p, a, x):
        tp = {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}
        return gcn.forward(tp, a, torch.from_numpy(x)).numpy()

    return types.SimpleNamespace(
        csc=csc, exe=executor, schedule=schedule, synth=synth, ge=gcn_engine,
        placement=placement, registry=registry, runner=runner,
        mesh=lambda n: ["cpu"] * n, one={"device": "cpu"}, gold=gold,
        device_of=lambda out: out.device,
        unit_out=lambda u, x: u.executor.forward_batch(
            u.params, torch.from_numpy(x[None]))[0].numpy(),
        primary=lambda eng: eng.devices[0],
    )


def _pl(p):
    return [p.kind, p.device_index, list(p.device_indices)]


def _engine(P, root, **kw):
    kw.setdefault("autotune_kwargs", KW)
    return P.ge.GCNServingEngine(store_root=root, **kw)


# ---------------------------------------------------------------------------
# Scenarios: each returns (observations, arrays)
# ---------------------------------------------------------------------------


def scenario_mesh(P):
    """tests/test_placement.py SCRIPT_MESH: distinct-position bin-packing,
    the sharded giant, deadline auto-flush, warm restarts on both routes,
    migration under concentrated eviction pressure."""
    SHARDED, SINGLE = P.placement.SHARDED, P.placement.SINGLE
    obs, arrs = {}, {}

    def workload(n, density, seed):
        return (P.synth.power_law_adjacency(n, density, 0.9, seed=seed),
                _glorot(seed), _x(n, seed))

    small = {f"g{i}": workload(260, 0.03, i) for i in range(4)}
    giant = workload(3000, 0.01, 99)
    est_small = max(a.nnz * 16 + 3000 for a, _, _ in small.values())
    budget = 6 * est_small
    assert giant[0].nnz * 16 > budget
    root = tempfile.mkdtemp(prefix="awb-mesh-")
    eng = _engine(P, root, devices=P.mesh(8), device_budget_bytes=budget)
    for gid, (a, params, x) in small.items():
        rep = eng.add_graph(gid, a, params)
        assert rep.placement.kind == SINGLE
        out = eng.infer(gid, x)
        obs[f"admit-{gid}"] = [_pl(rep.placement), rep.warm_start, int(rep.device_bytes)]
        arrs[f"infer-{gid}"] = np.asarray(out)
    assert len({obs[f"admit-{g}"][0][1] for g in small}) == 4

    a_g, p_g, x_g = giant
    rep = eng.add_graph("giant", a_g, p_g)
    assert rep.placement.kind == SHARDED and rep.placement.n_devices == 8
    assert isinstance(eng._graphs["giant"].executor, P.exe.ShardedScheduleExecutor)
    assert eng._graphs["giant"].executor.n_devices == 8 and rep.config.n_devices == 8
    got = np.asarray(eng.infer("giant", x_g))
    ref = P.gold(p_g, a_g, x_g)
    np.testing.assert_allclose(got, ref, atol=1e-3)
    obs["giant"] = [_pl(rep.placement), int(rep.device_bytes), rep.config.n_devices]
    arrs["giant"] = got

    xs = [x_g, x_g * 0.5]
    for xi in xs:
        eng.submit("giant", xi, deadline_s=60.0)
    for gid, (a, params, x) in small.items():
        eng.submit(gid, x, deadline_s=30.0)
    assert eng.poll() == {}
    out = eng.poll(now=time.monotonic() + 61.0)
    assert set(out) == set(small) | {"giant"}
    assert np.array_equal(np.asarray(out["giant"]), np.asarray(eng.serve_batch("giant", xs)))
    for gid, (a, params, x) in small.items():
        assert np.array_equal(np.asarray(out[gid]), np.asarray(eng.serve_batch(gid, [x])))
    st = eng.stats()
    assert st["deadline_met"] == 6 and st["deadline_misses"] == 0
    obs["deadline"] = {k: st[k] for k in ("deadline_met", "deadline_misses", "batches",
                                          "requests", "store_hits", "store_misses")}
    arrs["deadline-giant"] = np.asarray(out["giant"])

    P.registry.clear_caches()
    eng2 = _engine(P, root, devices=P.mesh(8), device_budget_bytes=budget)
    warm = []
    for gid, (a, params, x) in small.items():
        rep = eng2.add_graph(gid, a, params)
        assert rep.warm_start and rep.tune_seconds == 0.0
        warm.append(_pl(rep.placement))
    rep = eng2.add_graph("giant", a_g, p_g)
    assert rep.warm_start and rep.placement.kind == SHARDED
    assert eng2.counters["store_hits"] == 5 and eng2.counters["store_misses"] == 0
    got = np.asarray(eng2.infer("giant", x_g))
    np.testing.assert_allclose(got, ref, atol=1e-3)
    obs["warm"] = warm + [_pl(rep.placement)]

    P.registry.clear_caches()
    per_graph = {gid: eng._graphs[gid].bytes for gid in small}
    tight = int(max(per_graph.values()) * 1.3)
    eng3 = _engine(P, root, devices=P.mesh(2), device_budget_bytes=tight,
                   rebalance_after=3)
    refs = {}
    for gid in ("g0", "g1", "g2"):
        a, params, x = small[gid]
        rep = eng3.add_graph(gid, a, params)
        assert rep.warm_start and rep.placement.kind == SINGLE
        refs[gid] = P.gold(params, a, x)
    placed = {gid: eng3.placer.placements[gid].device_index for gid in ("g0", "g1", "g2")}
    shared = [d for d in set(placed.values())
              if sum(1 for v in placed.values() if v == d) == 2]
    assert shared, placed
    pair = sorted(g for g, d in placed.items() if d == shared[0])
    for _ in range(6):
        for gid in pair:
            np.testing.assert_allclose(np.asarray(eng3.infer(gid, small[gid][2])),
                                       refs[gid], atol=1e-3)
    assert eng3.counters["rebalances"] >= 1 and eng3.counters["evictions"] >= 3
    for gid in ("g0", "g1", "g2"):
        np.testing.assert_allclose(np.asarray(eng3.infer(gid, small[gid][2])),
                                   refs[gid], atol=1e-3)
    obs["rebalance"] = {
        "placed": placed,
        "final": {g: _pl(eng3.placer.placements[g]) for g in ("g0", "g1", "g2")},
        "counters": {k: eng3.counters[k] for k in ("rebalances", "evictions",
                                                   "readmissions", "store_hits")},
    }
    return obs, arrs


def scenario_replica(P):
    """tests/test_placement.py SCRIPT_REPLICA: the max_replicas=1 baseline,
    warm replica growth, bit-identical logits whichever replica served,
    replica shedding before eviction, shrink under idle polls."""
    REPLICATED, SINGLE = P.placement.REPLICATED, P.placement.SINGLE
    obs, arrs = {}, {}
    n = 300
    a = P.synth.power_law_adjacency(n, 0.03, 0.9, seed=5)
    params = _glorot(5)
    x = _x(n, 5)
    reqs = [x * (1.0 - 0.02 * i) for i in range(12)]
    root = tempfile.mkdtemp(prefix="awb-replica-")
    ref_eng = _engine(P, root, devices=P.mesh(8), max_replicas=1, replicate_after_s=1e-6)
    ref_eng.add_graph("hot", a, params)
    ref = np.asarray(ref_eng.serve_batch("hot", reqs))
    for r in reqs:
        ref_eng.submit("hot", r, deadline_s=0.0)
    assert set(ref_eng.poll()) == {"hot"}
    assert ref_eng.stats()["replicas"] == {} and ref_eng.counters["replicas_added"] == 0
    arrs["single"] = ref

    P.registry.clear_caches()
    eng = _engine(P, root, devices=P.mesh(8), max_replicas=3, replicate_after_s=1e-6,
                  replica_shrink_after=2)
    assert eng.add_graph("hot", a, params).warm_start
    eng.serve_batch("hot", reqs[:2])
    assert eng._svc_req_ewma["hot"] > 0
    orig_measure = P.runner.measure_candidate
    orig_build = P.schedule.build_balanced_schedule

    def forbid(what):
        def f(*a_, **k_):
            raise AssertionError(f"{what} during replica growth")
        return f

    P.runner.measure_candidate = forbid("measured sweep")
    P.schedule.build_balanced_schedule = forbid("schedule rebuild")
    try:
        outs = []
        for _ in range(3):
            for r in reqs:
                eng.submit("hot", r, deadline_s=0.0)
            outs.append(np.asarray(eng.poll()["hot"]))
        pl = eng.placer.placement_of("hot")
        assert pl.kind == REPLICATED and len(set(pl.device_indices)) == 3, pl
        assert eng.counters["replicas_added"] == 2
        st = eng.stats()
        assert st["replicas"] == {"hot": list(pl.device_indices)}
        per_dev = {d["device"]: d["resident"] for d in st["per_device"]}
        for d in pl.device_indices:
            assert "hot" in per_dev[d]
        for d, unit in eng._graphs["hot"].replicas.items():
            assert unit.executor.device == eng.devices[d]
        obs["grow"] = [_pl(pl), st["replicas"], eng.counters["replicas_added"]]
        for out in outs:
            assert np.array_equal(out, ref), "replica outputs diverged"
        direct = np.asarray(eng.serve_batch("hot", reqs))
        assert np.array_equal(direct, ref)
        one = eng.serve_batch("hot", [x])
        assert P.device_of(one) == P.primary(eng)
    finally:
        P.runner.measure_candidate = orig_measure
        P.schedule.build_balanced_schedule = orig_build

    a2 = P.synth.power_law_adjacency(260, 0.03, 0.9, seed=6)
    eng.add_graph("cold", a2, _glorot(6))
    eng.infer("cold", _x(260, 6))
    sec = sorted(eng._graphs["hot"].replicas)[0]
    drops = eng.counters["replicas_dropped"]
    eng.placer.used[sec] += eng.placer.budget  # simulated pressure on sec
    eng._evict_over_budget(keep="cold")
    eng.placer.used[sec] -= eng.placer.budget
    assert eng.counters["replicas_dropped"] == drops + 1
    assert sec not in eng._graphs["hot"].replicas
    assert eng._graphs["hot"].executor is not None and eng.counters["evictions"] == 0
    obs["shed"] = [sec, _pl(eng.placer.placement_of("hot"))]

    bytes_replicated = eng.device_bytes_in_use
    for _ in range(8):
        eng.poll()
    pl = eng.placer.placement_of("hot")
    assert pl.kind == SINGLE, pl
    assert eng.counters["replicas_dropped"] == 2
    assert eng.device_bytes_in_use < bytes_replicated
    assert eng._graphs["hot"].replicas == {}
    assert np.array_equal(np.asarray(eng.serve_batch("hot", reqs)), ref)
    obs["shrink"] = [_pl(pl), {k: eng.counters[k] for k in (
        "replicas_added", "replicas_dropped", "evictions", "store_hits", "batches")}]
    return obs, arrs


def scenario_faults(P):
    """tests/test_faults.py SCRIPT_REPLICA_FAULTS: sibling retry, every clone
    poisoned, the direct path's typed failure, per-request partial
    failure."""
    REPLICATED, FAULTS = P.placement.REPLICATED, P.exe.FAULTS
    obs, arrs = {}, {}

    def identity(eng):
        st = eng.stats()
        assert st["submitted"] == (st["queue_served"] + st["shed"] + st["rejected"]
                                   + st["pending_requests"]), st

    def settled(eng):
        assert all(v <= 1e-9 for v in eng._dev_outstanding.values()), eng._dev_outstanding

    n = 300
    a = P.synth.power_law_adjacency(n, 0.03, 0.9, seed=5)
    params = _glorot(5)
    x = _x(n, 5)
    reqs = [x * (1.0 - 0.02 * i) for i in range(12)]
    root = tempfile.mkdtemp(prefix="awb-faults-")
    FAULTS.clear()
    eng = _engine(P, root, devices=P.mesh(8), max_replicas=3, replicate_after_s=1e-6,
                  replica_shrink_after=10**6)
    eng.add_graph("hot", a, params)
    ref = np.asarray(eng.serve_batch("hot", reqs))
    for _ in range(3):
        for r in reqs:
            eng.submit("hot", r, deadline_s=0.0)
        eng.poll()
    pl = eng.placer.placement_of("hot")
    assert pl.kind == REPLICATED and len(pl.device_indices) == 3, pl

    victim = sorted(eng._graphs["hot"].replicas)[0]
    FAULTS.arm("replica_chunk", graph="hot", device=victim, times=1)
    out = np.asarray(eng.serve_batch("hot", reqs))
    assert np.array_equal(out, ref), "sibling retry changed the logits"
    assert not FAULTS._armed and FAULTS.fired == [("replica_chunk", "hot", victim)]
    assert eng.counters["chunk_retries"] >= 1
    settled(eng)
    obs["sibling"] = [victim, [list(f) for f in FAULTS.fired], eng.counters["chunk_retries"]]

    FAULTS.clear()
    for r in reqs:
        eng.submit("hot", r, deadline_s=0.0)
    FAULTS.arm("replica_chunk", graph="hot", times=999)
    try:
        eng.poll()
        raise AssertionError("expected FlushError")
    except P.ge.FlushError as e:
        assert set(e.failures) == {"hot"}
    assert len(eng._pending["hot"]) == 12
    settled(eng)
    identity(eng)
    FAULTS.clear()
    assert np.array_equal(np.asarray(eng.poll()["hot"]), ref)
    identity(eng)
    obs["poison"] = {k: eng.counters[k] for k in ("request_failures", "chunk_retries",
                                                  "queue_served", "batches")}

    FAULTS.arm("replica_chunk", graph="hot", times=999)
    before = dict(eng.counters)
    try:
        eng.serve_batch("hot", reqs)
        raise AssertionError("expected RequestFailure")
    except P.ge.RequestFailure as e:
        assert e.n_failed == 12 and e.partial is None
    assert eng.counters["batches"] == before["batches"]
    assert eng.counters["requests"] == before["requests"]
    FAULTS.clear()

    sentinel = np.float32(12345.0)
    bad = reqs[0].copy()
    bad[0, 0] = sentinel
    orig_run = eng._run_unit

    def poisoned(unit, gid, chunk):
        if np.any(np.asarray(chunk)[:, 0, 0] == sentinel):
            raise RuntimeError("poisoned chunk")
        return orig_run(unit, gid, chunk)

    eng._run_unit = poisoned
    for r in [bad] + reqs[1:]:
        eng.submit("hot", r, deadline_s=0.0)
    try:
        eng.poll()
        raise AssertionError("expected FlushError")
    except P.ge.FlushError as e:
        part = np.asarray(e.partial["hot"])
    restored = eng._pending["hot"]
    assert len(restored) == 4
    assert float(np.asarray(restored[0].x)[0, 0]) == float(sentinel)
    assert np.array_equal(part, ref[4:])
    settled(eng)
    identity(eng)
    del eng._run_unit
    out = np.asarray(eng.flush()["hot"])
    assert out.shape == (4, n, 4)
    identity(eng)
    obs["partial"] = {k: eng.counters[k] for k in (
        "request_failures", "chunk_retries", "queue_served", "submitted", "batches")}
    arrs["ref"] = ref
    return obs, arrs


def scenario_stream(P):
    """tests/test_streaming.py SCRIPT_STREAM: updates into a sharded graph,
    into a replicated one (every clone spliced), and the collapse back to
    one clone."""
    REPLICATED, SHARDED, SINGLE = (P.placement.REPLICATED, P.placement.SHARDED,
                                   P.placement.SINGLE)
    obs, arrs = {}, {}

    def pinned_kw(cfg):
        cand = dict(nnz_per_step=cfg.nnz_per_step, rows_per_window=cfg.rows_per_window,
                    cols_per_block=cfg.cols_per_block, window_nnz=cfg.window_nnz,
                    routing=cfg.routing, ktile=cfg.ktile)
        return dict(iters=1, warmup=1, sweep=[cand], bf16_report=False)

    def value_delta(coo, k, rng):
        row, col = np.asarray(coo.row), np.asarray(coo.col)
        idx = rng.choice(row.shape[0], size=k, replace=False)
        return P.csc.EdgeDelta(row[idx], col[idx], (rng.random(k) + 0.5).astype(np.float32))

    def structural_delta(n, k, rng):
        return P.csc.EdgeDelta(rng.integers(0, n, k), rng.integers(0, n, k),
                               (rng.random(k) + 0.1).astype(np.float32))

    n = 3000
    a = P.synth.power_law_adjacency(n, 0.01, 0.9, seed=99)
    params = _glorot(99)
    x = _x(n, 99)
    budget = a.nnz * 4
    rng = np.random.default_rng(17)
    eng = _engine(P, tempfile.mkdtemp(prefix="awb-stream-mesh-"), devices=P.mesh(8),
                  device_budget_bytes=budget)
    rep = eng.add_graph("g", a, params)
    assert rep.placement.kind == SHARDED
    eng.infer("g", x)
    reports = []
    for i in range(4):
        coo = eng._graphs["g"].coo
        delta = value_delta(coo, 12, rng) if i % 2 == 0 else structural_delta(n, 12, rng)
        urep = eng.update_graph("g", delta)
        assert urep.repaired and not urep.fell_back, urep
        reports.append([urep.repaired, urep.fell_back, urep.revision, urep.nnz,
                        urep.steps_reused, urep.windows_reused])
    got = np.asarray(eng.infer("g", x))
    rec = eng._graphs["g"]
    ident = _engine(P, tempfile.mkdtemp(prefix="awb-stream-ident-"), devices=P.mesh(8),
                    device_budget_bytes=budget, autotune_kwargs=pinned_kw(rec.config))
    ident.add_graph("g", rec.coo, params)
    assert np.array_equal(got, np.asarray(ident.infer("g", x)))
    obs["sharded"] = reports
    arrs["sharded"] = got
    eng.drain_persists()

    n2 = 260
    a2 = P.synth.power_law_adjacency(n2, 0.03, 0.9, seed=5)
    p2 = _glorot(5)
    x2 = _x(n2, 5)
    eng2 = _engine(P, tempfile.mkdtemp(prefix="awb-stream-rep-"), devices=P.mesh(8))
    eng2.add_graph("h", a2, p2)
    eng2.infer("h", x2)
    rec2 = eng2._graphs["h"]
    assert eng2._grow_replica(rec2)
    assert eng2.placer.placement_of("h").kind == REPLICATED
    urep = eng2.update_graph("h", value_delta(rec2.coo, 10, rng))
    assert urep.repaired and urep.scoped_upload
    outs = [P.unit_out(u, x2) for u in eng2._units(rec2)]
    assert len(outs) == 2 and np.array_equal(outs[0], outs[1])
    ident2 = _engine(P, tempfile.mkdtemp(prefix="awb-stream-rident-"),
                     autotune_kwargs=pinned_kw(rec2.config), **P.one)
    ident2.add_graph("h", rec2.coo, p2)
    assert np.array_equal(outs[0], np.asarray(ident2.infer("h", x2)))
    obs["replica"] = [_pl(eng2.placer.placement_of("h")), urep.scoped_upload,
                      urep.revision]
    arrs["replica"] = outs[0]

    eng2._svc_ewma["h"] = 0.123
    eng2._svc_req_ewma["h"] = 0.456
    (shed_dev,) = list(rec2.replicas)
    eng2._drop_replica(rec2, shed_dev)
    assert eng2.placer.placement_of("h").kind == SINGLE
    assert "h" not in eng2._svc_ewma and "h" not in eng2._svc_req_ewma
    obs["collapse"] = [shed_dev, _pl(eng2.placer.placement_of("h"))]
    for e in (eng2, ident, ident2):
        e.drain_persists()
    return obs, arrs


SCENARIOS = {"mesh": scenario_mesh, "replica": scenario_replica,
             "faults": scenario_faults, "stream": scenario_stream}


# ---------------------------------------------------------------------------
# The reference run (one subprocess for the module)
# ---------------------------------------------------------------------------

REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys, json
sys.path.insert(0, %(src)r)
sys.path.insert(0, %(tests)r)
import numpy as np, jax
import test_torch_mesh_engine as T
assert len(jax.devices()) == 8
P = T.reference_pkg()
obs, arrs = {}, {}
for name, fn in T.SCENARIOS.items():
    o, a = fn(P)
    obs[name] = o
    arrs.update({f"{name}/{k}": v for k, v in a.items()})
    print(name.upper(), "OK", flush=True)
out = sys.argv[1]
with open(out + ".json", "w") as f:
    json.dump(obs, f)
np.savez(out + ".npz", **arrs)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("mesh-ref") / "ref")
    script = REF_SCRIPT % {"src": SRC, "tests": str(Path(__file__).parent)}
    r = subprocess.run([sys.executable, "-c", script, base], capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr[-3000:]}"
    with open(base + ".json") as f:
        obs = json.load(f)
    return obs, dict(np.load(base + ".npz"))


@pytest.fixture
def port():
    from repro_torch.core.executor import FAULTS
    from repro_torch.tuning import registry

    registry.clear_caches()
    FAULTS.clear()
    yield port_pkg()
    registry.clear_caches()
    FAULTS.clear()


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference_decision_for_decision(ref, port, name):
    obs, arrs = SCENARIOS[name](port)
    ref_obs, ref_arrs = ref
    # JSON round trip: tuples become lists, int keys strings, as the
    # reference's record went through it
    assert json.loads(json.dumps(obs)) == ref_obs[name]
    for key, got in arrs.items():
        want = ref_arrs[f"{name}/{key}"]
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got, want, atol=TOL, err_msg=key)


# ---------------------------------------------------------------------------
# tests/test_reorder.py: the un-permutation survives the ordered sum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", (2, 4, 8))
@pytest.mark.parametrize("strat", ["degree", "island"])
@pytest.mark.parametrize("kernels", [False, True])
def test_sharded_reorder_round_trips(monkeypatch, port, strat, d, kernels):
    """Dyadic values and small-integer B make every sum exact, so the
    sharded product of a reordered schedule equals the dense product bit
    for bit, whatever the shard split (the reference's exact check)."""
    from repro_torch.core import csc as fmt
    from repro_torch.core import executor as texe

    if kernels:
        monkeypatch.setattr(texe, "_runs_kernels", lambda device: True)
    a = port.synth.power_law_adjacency(300, 0.03, 0.9, seed=7)
    row = fmt.to_numpy(a.row)
    keep = row != fmt.PAD_IDX
    a = fmt.coo_from_arrays(row[keep], fmt.to_numpy(a.col)[keep],
                            np.full(int(keep.sum()), 0.5, np.float32), a.shape)
    rng = np.random.default_rng(0)
    b = rng.integers(-4, 5, (300, 6)).astype(np.float32)
    dense = np.zeros(a.shape, np.float64)
    dense[fmt.to_numpy(a.row), fmt.to_numpy(a.col)] = fmt.to_numpy(a.val)
    ex = port.registry.get_executor(a, nnz_per_step=32, rows_per_window=16,
                                    mesh=port.mesh(d), reorder=strat)
    assert ex.row_unperm is not None
    np.testing.assert_array_equal(ex.spmm(torch.from_numpy(b)).numpy(), dense @ b)
