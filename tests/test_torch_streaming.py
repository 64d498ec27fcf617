"""Streaming graph updates in the port, against the reference on the same
numpy inputs: ``registry.delta_fingerprint``, the value-patched and
repaired executors (copy-on-write, scoped re-upload), the kernels' plan
spliced by ``spmm_cuda.splice_plan`` — the card path's host half — and
``GCNServingEngine.update_graph`` with its versioned swap, drift re-tune,
async persist and lock discipline. Mirrors ``tests/test_streaming.py``'s
executor and engine cases and the thread fuzz of
``tests/test_analysis_dynamic.py``, case for case."""
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.analysis.dynamic import guarded  # noqa: E402
from repro.core import csc as jfmt  # noqa: E402
from repro.core import executor as jexe  # noqa: E402
from repro.core import gcn as jgcn  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.graphs import synth as jsynth  # noqa: E402
from repro.serving import gcn_engine as jge  # noqa: E402
from repro.tuning import registry as jreg  # noqa: E402
from repro_torch.core import csc as tfmt  # noqa: E402
from repro_torch.core import executor as texe  # noqa: E402
from repro_torch.core import gcn as tgcn  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core.executor import FAULTS, InjectedFault  # noqa: E402
from repro_torch.graphs import synth as tsynth  # noqa: E402
from repro_torch.kernels import spmm_cuda  # noqa: E402
from repro_torch.serving import UpdateReport  # noqa: E402
from repro_torch.serving import gcn_engine as ge  # noqa: E402
from repro_torch.serving.errors import UnknownGraphError  # noqa: E402
from repro_torch.tuning import registry, runner  # noqa: E402

N_NODES = 220
N_FEATS = 20
N_CLASSES = 5
SCHED_KW = dict(nnz_per_step=64, rows_per_window=32)
#: a one-candidate sweep, so both engines tune the same config (a timed
#: two-candidate sweep may pick different winners in the two packages)
ONE = dict(nnz_per_step=64, rows_per_window=32, cols_per_block=None,
           window_nnz=None, routing="gather")
ONE_KW = dict(iters=1, warmup=1, sweep=[ONE], bf16_report=False)
TOL = 1e-4
CPU = torch.device("cpu")
#: engines a test made, whose persist workers its teardown drains: no test
#: leaves background work running into the next one or into the exit
_ENGINES = []


@pytest.fixture(autouse=True)
def _fresh_caches():
    registry.clear_caches()
    jreg.clear_caches()
    FAULTS.clear()
    yield
    while _ENGINES:
        _ENGINES.pop().drain_persists()
    registry.clear_caches()
    jreg.clear_caches()
    FAULTS.clear()


def _graph(seed, n=N_NODES, density=0.03):
    return (tsynth.power_law_adjacency(n, density, 0.9, seed=seed),
            jsynth.power_law_adjacency(n, density, 0.9, seed=seed))


def _params(seed):
    cfg = jgcn.GCNConfig(N_FEATS, 16, N_CLASSES)
    return {k: np.asarray(v)
            for k, v in jgcn.init_params(cfg, jax.random.PRNGKey(seed)).items()}


def _x(seed):
    return np.random.default_rng(seed).random((N_NODES, N_FEATS)).astype(np.float32)


def _value_delta(coo, k, rng):
    row, col = tfmt.to_numpy(coo.row), tfmt.to_numpy(coo.col)
    idx = rng.choice(row.shape[0], size=min(k, row.shape[0]), replace=False)
    vals = (rng.random(idx.shape[0]) + 0.5).astype(np.float32)
    return jfmt.EdgeDelta(row[idx], col[idx], vals)


def _structural_delta(n, k, rng):
    rows = rng.integers(0, n, k)
    cols = rng.integers(0, n, k)
    vals = (rng.random(k) + 0.1).astype(np.float32)
    return jfmt.EdgeDelta(rows, cols, vals)


def _move_delta(coo, rng):
    """Remove one edge and insert one absent edge in the same row: every
    row keeps its non-zero count, so windows and step sizes stay."""
    row, col = tfmt.to_numpy(coo.row), tfmt.to_numpy(coo.col)
    i = int(rng.integers(row.shape[0]))
    r = int(row[i])
    absent = np.setdiff1d(np.arange(coo.shape[1]), col[row == r])
    c1 = int(rng.choice(absent))
    return jfmt.EdgeDelta(np.array([r, r]), np.array([col[i], c1]),
                          np.array([0.0, 0.75], np.float32))


def _clear_delta(coo):
    """Remove every edge: the repair degenerates to a full rebuild."""
    row, col = tfmt.to_numpy(coo.row), tfmt.to_numpy(coo.col)
    return jfmt.EdgeDelta(row, col, np.zeros(row.shape[0], np.float32))


def _per_row(coo, n=N_NODES):
    return np.bincount(tfmt.to_numpy(coo.row).astype(np.int64), minlength=n)


def _repair(ts, ta, delta, **kw):
    """Apply ``delta`` and repair ``ts`` in the port: (new COO, schedule,
    stats)."""
    new, rep = tfmt.apply_edge_delta(ta, delta, with_report=True)
    pro = _per_row(ta, ts.shape[0])
    prn = pro.copy()
    prn[rep.touched_rows] += rep.row_nnz_delta
    ns, stats = tsched.repair_schedule(ts, None, new, rep.touched_rows,
                                       per_row_old=pro, per_row_new=prn, **kw)
    return new, ns, stats


def _same_sched(t, j):
    for f in tsched._ARRAY_FIELDS:
        assert np.array_equal(getattr(t, f), getattr(j, f)), f
    assert tuple(t.shape) == tuple(j.shape)


def _snapshot(tensors):
    return [t.clone() for t in tensors]


def _unchanged(tensors, copies):
    assert all(torch.equal(t, c) for t, c in zip(tensors, copies))


# ---------------------------------------------------------------------------
# delta_fingerprint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["value", "structural", "empty"])
@pytest.mark.parametrize("revision", [1, 7])
def test_delta_fingerprint_matches_reference(kind, revision):
    ta, ja = _graph(0)
    rng = np.random.default_rng(revision)
    none = np.zeros(0, np.int64)
    delta = {"value": lambda: _value_delta(ta, 8, rng),
             "structural": lambda: _structural_delta(N_NODES, 8, rng),
             "empty": lambda: jfmt.EdgeDelta(none, none, np.zeros(0, np.float32)),
             }[kind]()
    fp = registry.graph_fingerprint(ta)
    assert fp == jreg.graph_fingerprint(ja)
    want = jreg.delta_fingerprint(fp, delta, revision)
    assert registry.delta_fingerprint(fp, delta, revision) == want
    as_tensors = tfmt.EdgeDelta(*(torch.from_numpy(np.asarray(x)) for x in delta))
    assert registry.delta_fingerprint(fp, as_tensors, revision) == want
    assert registry.delta_fingerprint(fp, delta, revision + 1) != want


# ---------------------------------------------------------------------------
# executors on the CPU gather routing
# ---------------------------------------------------------------------------


def _cpu_arrays(ex):
    return [ex._gcol, ex._tgt, ex._val]


def test_value_patched_executor_matches_fresh_and_reference():
    ta, ja = _graph(6)
    rng = np.random.default_rng(6)
    ts = tsched.build_balanced_schedule(ta, **SCHED_KW)
    js = jsched.build_balanced_schedule(ja, **SCHED_KW)
    ex = texe.ScheduleExecutor(ts, routing="gather", device=CPU)
    jex = jexe.ScheduleExecutor(js, routing=jexe.GATHER)
    before = _snapshot(_cpu_arrays(ex))
    delta = _value_delta(ta, 9, rng)
    tp, slots = tsched.value_patch_schedule(ts, tsched.slot_entry_keys(ts),
                                            delta.row, delta.col, delta.val)
    jp, jslots = jsched.value_patch_schedule(js, jsched.slot_entry_keys(js),
                                             delta.row, delta.col, delta.val)
    ex2 = texe.value_patched_executor(ex, tp, slots, tp.val[slots])
    jex2 = jexe.value_patched_executor(jex, jp, jslots, jp.val[jslots])
    assert ex2 is not ex and ex2.sched is tp
    assert ex2.scoped_upload and jex2.scoped_upload
    assert ex2.device_bytes == ex.device_bytes
    assert ex2._gcol is ex._gcol and ex2._tgt is ex._tgt and ex2._val is not ex._val
    fresh = texe.ScheduleExecutor(tp, routing="gather", device=CPU)
    for got, want, ref in zip(_cpu_arrays(ex2), _cpu_arrays(fresh), [
            jex2._gcol, jex2._tgt, jex2._val]):
        assert torch.equal(got, want)
        assert np.array_equal(got.numpy(), np.asarray(ref))
    b = np.random.default_rng(60).random((N_NODES, 16)).astype(np.float32)
    got = ex2.spmm(torch.from_numpy(b))
    assert torch.equal(got, fresh.spmm(torch.from_numpy(b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jex2.spmm(jnp.asarray(b))),
                               atol=TOL)
    _unchanged(_cpu_arrays(ex), before)
    # empty patch: the device stream is shared outright, no upload
    ex3 = texe.value_patched_executor(ex, ts, np.zeros(0, np.int64),
                                      np.zeros(0, np.float32))
    assert ex3._val is ex._val


@pytest.mark.parametrize("kind", ["structural", "move"])
def test_repaired_executor_scoped_matches_fresh_and_reference(monkeypatch, kind):
    monkeypatch.setattr(texe, "SCOPED_UPLOAD_MIN_BYTES", 0)
    monkeypatch.setattr(jexe, "SCOPED_UPLOAD_MIN_BYTES", 0)
    ta, ja = _graph(7)
    rng = np.random.default_rng(7)
    ts = tsched.build_balanced_schedule(ta, **SCHED_KW)
    js = jsched.build_balanced_schedule(ja, **SCHED_KW)
    ex = texe.ScheduleExecutor(ts, routing="gather", device=CPU)
    jex = jexe.ScheduleExecutor(js, routing=jexe.GATHER)
    before = _snapshot(_cpu_arrays(ex))
    delta = (_structural_delta(N_NODES, 20, rng) if kind == "structural"
             else _move_delta(ta, rng))
    tnew, tns, tstats = _repair(ts, ta, delta, **SCHED_KW)
    jnew, jrep = jfmt.apply_edge_delta(ja, delta, with_report=True)
    jpro = np.bincount(np.asarray(ja.row), minlength=N_NODES)
    jprn = jpro.copy()
    jprn[jrep.touched_rows] += jrep.row_nnz_delta
    jns, jstats = jsched.repair_schedule(js, None, jnew, jrep.touched_rows,
                                         per_row_old=jpro, per_row_new=jprn, **SCHED_KW)
    _same_sched(tns, jns)
    assert np.array_equal(tstats.step_src, jstats.step_src)
    ex2 = texe.repaired_executor(ex, tns, tstats)
    jex2 = jexe.repaired_executor(jex, jns, jstats)
    assert ex2.scoped_upload == jex2.scoped_upload
    if kind == "move":  # same grid, a few moved steps: the scoped patch
        assert ex2.scoped_upload
    fresh = texe.ScheduleExecutor(tns, routing="gather", device=CPU)
    for got, want, ref in zip(_cpu_arrays(ex2), _cpu_arrays(fresh), [
            jex2._gcol, jex2._tgt, jex2._val]):
        assert torch.equal(got, want)
        assert np.array_equal(got.numpy(), np.asarray(ref))
    for got, want in zip(ex2._host, fresh._host):
        assert np.array_equal(got, want)
    b = np.random.default_rng(70).random((N_NODES, 16)).astype(np.float32)
    got = ex2.spmm(torch.from_numpy(b))
    assert torch.equal(got, fresh.spmm(torch.from_numpy(b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jex2.spmm(jnp.asarray(b))),
                               atol=TOL)
    _unchanged(_cpu_arrays(ex), before)


def test_onehot_and_fallback_rebuild_cold():
    ta, _ = _graph(8)
    rng = np.random.default_rng(8)
    ts = tsched.build_balanced_schedule(ta, **SCHED_KW)
    ex = texe.ScheduleExecutor(ts, routing="onehot", device=CPU)
    tnew, tns, tstats = _repair(ts, ta, _structural_delta(N_NODES, 10, rng),
                                **SCHED_KW)
    ex2 = texe.repaired_executor(ex, tns, tstats)
    assert ex2.routing == "onehot" and not ex2.scoped_upload
    b = torch.from_numpy(np.random.default_rng(80).random((N_NODES, 8))
                         .astype(np.float32))
    fresh = texe.ScheduleExecutor(tns, routing="onehot", device=CPU)
    assert torch.equal(ex2.spmm(b), fresh.spmm(b))
    gex = texe.ScheduleExecutor(ts, routing="gather", device=CPU)
    _, cleared, fell = _repair(ts, ta, _clear_delta(ta), **SCHED_KW)
    assert fell.fell_back
    ex3 = texe.repaired_executor(gex, cleared, fell)
    assert not ex3.scoped_upload
    assert torch.equal(ex3.spmm(b), torch.zeros_like(ex3.spmm(b)))


def test_dispatchers_reject_other_executor_types():
    ta, _ = _graph(9)
    ts = tsched.build_balanced_schedule(ta, **SCHED_KW)
    with pytest.raises(TypeError, match="unsupported executor type"):
        texe.repaired_executor(object(), ts, None)
    with pytest.raises(TypeError, match="unsupported executor type"):
        texe.value_patched_executor(object(), ts, [], [])


def test_scoped_patch_consults_the_upload_fault_seam(monkeypatch):
    monkeypatch.setattr(texe, "SCOPED_UPLOAD_MIN_BYTES", 0)
    ta, _ = _graph(10)
    rng = np.random.default_rng(10)
    ts = tsched.build_balanced_schedule(ta, **SCHED_KW)
    ex = texe.ScheduleExecutor(ts, routing="gather", device=CPU)
    delta = _value_delta(ta, 4, rng)
    tp, slots = tsched.value_patch_schedule(ts, tsched.slot_entry_keys(ts),
                                            delta.row, delta.col, delta.val)
    FAULTS.arm("upload")
    with pytest.raises(InjectedFault):
        texe.value_patched_executor(ex, tp, slots, tp.val[slots])
    steps, plan = texe._device_plan(ts, CPU)
    FAULTS.arm("upload")
    with pytest.raises(InjectedFault):
        texe.patched_steps(steps, plan, ts.nnz_per_step, slots, tp.val[slots])


# ---------------------------------------------------------------------------
# the kernels' plan, spliced (the card path's host half, on CPU tensors)
# ---------------------------------------------------------------------------

#: (schedule geometry, delta) cases: a value delta, a structural delta, a
#: delta that dirties the evil-row section, a same-layout move, and a
#: repair that falls back to a full rebuild
PLAN_CASES = ["value", "structural", "evil", "move", "fell_back"]
EVIL_KW = dict(nnz_per_step=16, rows_per_window=8, cols_per_block=64, evil_threshold=8)


def _plan_case(kind, rng):
    """(old schedule, old plan, new schedule, repair stats or value slots)."""
    kw = EVIL_KW if kind == "evil" else SCHED_KW
    ta, _ = _graph(11, density=0.05 if kind == "evil" else 0.03)
    ts = tsched.build_balanced_schedule(ta, **kw)
    if kind == "value":
        delta = _value_delta(ta, 12, rng)
        tp, slots = tsched.value_patch_schedule(ts, tsched.slot_entry_keys(ts),
                                                delta.row, delta.col, delta.val)
        return ts, tp, slots
    if kind == "evil":
        hot = int(np.argmax(_per_row(ta)))
        delta = jfmt.EdgeDelta(np.full(6, hot), rng.integers(0, N_NODES, 6),
                               np.full(6, 0.5, np.float32))
    elif kind == "move":
        delta = _move_delta(ta, rng)
    elif kind == "fell_back":
        delta = _clear_delta(ta)
    else:
        delta = _structural_delta(N_NODES, 16, rng)
    _, tns, stats = _repair(ts, ta, delta, **kw)
    if kind == "evil":
        assert stats.evil_dirty and ts.n_evil_chunks > 0
    assert stats.fell_back == (kind == "fell_back")
    return ts, tns, stats


@pytest.mark.parametrize("kind", PLAN_CASES)
def test_spliced_plan_equals_kernel_plan(kind, monkeypatch):
    monkeypatch.setattr(texe, "SCOPED_UPLOAD_MIN_BYTES", 0)
    rng = np.random.default_rng(12)
    ts, tns, how = _plan_case(kind, rng)
    old_steps, old_plan = texe._device_plan(ts, CPU)
    host_before = {k: v.copy() for k, v in old_plan.items()}
    dev_before = _snapshot(old_steps[:5])
    if kind == "value":
        steps, plan = texe.patched_steps(old_steps, old_plan, ts.nnz_per_step,
                                         how, tns.val[how])
        scoped = True
        assert all(a is b for a, b in zip(steps[1:5], old_steps[1:5]))
    else:
        steps, plan, scoped = texe.spliced_steps(old_steps, old_plan, tns, how)
    cold = spmm_cuda.kernel_plan(tns)
    assert set(plan) == set(cold)
    for name in cold:
        assert np.array_equal(plan[name], cold[name]), name
        assert plan[name].dtype == cold[name].dtype, name
    for name, t in zip(spmm_cuda.DEVICE_FIELDS, steps[:5]):
        assert np.array_equal(t.numpy(), cold[name]), name
    assert steps.shape == tns.shape
    assert steps.n_parts == int(cold["part_ptr"][-1])
    assert scoped == (kind in ("value", "move"))
    # copy-on-write: the old plan and upload are untouched
    for name, v in host_before.items():
        assert np.array_equal(old_plan[name], v), name
    _unchanged(old_steps[:5], dev_before)
    b = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (N_NODES, 24)).astype(np.float32))
    cold_steps = texe._upload_plan(cold, tns.shape, CPU)
    for acc in (torch.float32, torch.bfloat16):
        assert torch.equal(spmm_cuda.spmm_balanced_plain(steps, b, acc_dtype=acc),
                           spmm_cuda.spmm_balanced_plain(cold_steps, b, acc_dtype=acc))


def test_splice_never_calls_the_full_plan(monkeypatch):
    monkeypatch.setattr(texe, "SCOPED_UPLOAD_MIN_BYTES", 0)
    rng = np.random.default_rng(14)
    ts, tns, stats = _plan_case("move", rng)
    vs, vp, slots = _plan_case("value", rng)
    old_steps, old_plan = texe._device_plan(ts, CPU)
    v_steps, v_plan = texe._device_plan(vs, CPU)

    def boom(_sched):
        raise AssertionError("kernel_plan called on the streaming path")

    monkeypatch.setattr(spmm_cuda, "kernel_plan", boom)
    _, _, scoped = texe.spliced_steps(old_steps, old_plan, tns, stats)
    assert scoped
    texe.patched_steps(v_steps, v_plan, vs.nnz_per_step, slots, vp.val[slots])


def test_value_patch_outside_the_live_slots_raises():
    rng = np.random.default_rng(15)
    ts, tp, slots = _plan_case("value", rng)
    steps, plan = texe._device_plan(ts, CPU)
    k = ts.nnz_per_step
    live = np.diff(plan["slot_ptr"])
    pad_step = int(np.flatnonzero(live < k)[0])
    with pytest.raises(ValueError, match="live slots"):
        texe.patched_steps(steps, plan, k, [pad_step * k + k - 1], [1.0])
    with pytest.raises(ValueError, match="to zero"):
        texe.patched_steps(steps, plan, k, slots[:1], [0.0])


def test_memo_registers_spliced_upload_and_releases_it():
    rng = np.random.default_rng(16)
    ts, tns, stats = _plan_case("structural", rng)
    steps, plan = texe._device_plan(ts, CPU)
    new_steps, new_plan, _ = texe.spliced_steps(steps, plan, tns, stats)
    texe._remember(tns, CPU, new_steps, new_plan)
    assert texe.device_step_arrays(tns, CPU) is new_steps
    texe.release_device_steps(ts)
    assert (id(ts), "cpu") not in texe._DEVICE_STEPS
    assert (id(tns), "cpu") in texe._DEVICE_STEPS
    texe.release_device_steps(tns, CPU)
    assert not texe._DEVICE_STEPS


# ---------------------------------------------------------------------------
# the engine: update_graph against the reference engine
# ---------------------------------------------------------------------------


def _engines(tmp_path, seed, **kw):
    ta, ja = _graph(seed)
    params = _params(seed)
    kw.setdefault("autotune_kwargs", ONE_KW)
    eng = ge.GCNServingEngine(store_root=tmp_path / "t", device="cpu", **kw)
    jeng = jge.GCNServingEngine(store_root=tmp_path / "j", **kw)
    _ENGINES.extend([eng, jeng])
    eng.add_graph("g", ta, tgcn.params_from_jax(params, "cpu"))
    jeng.add_graph("g", ja, params)
    return eng, jeng, params


def _engine(root, **kw):
    kw.setdefault("autotune_kwargs", ONE_KW)
    eng = ge.GCNServingEngine(store_root=root, device="cpu", **kw)
    _ENGINES.append(eng)
    return eng


def _pinned_engine(root, cfg):
    cand = dict(nnz_per_step=cfg.nnz_per_step, rows_per_window=cfg.rows_per_window,
                cols_per_block=cfg.cols_per_block, window_nnz=cfg.window_nnz,
                routing=cfg.routing, ktile=cfg.ktile)
    return _engine(root, autotune_kwargs=dict(iters=1, warmup=1, sweep=[cand],
                                              bf16_report=False))


REPORT_FIELDS = ("repaired", "revision", "lineage", "steps_reused", "windows_reused",
                 "windows_total", "fell_back", "nnz", "fingerprint", "scoped_upload")


@pytest.mark.parametrize("reorder", ["none", "degree"])
def test_update_chain_matches_reference_engine(tmp_path, reorder):
    kw = {} if reorder == "none" else dict(autotune_kwargs=dict(
        ONE_KW, sweep=[dict(ONE, reorder=reorder)]))
    eng, jeng, params = _engines(tmp_path, 9, **kw)
    if reorder != "none":
        assert eng._graphs["g"].perm is not None
    x = _x(9)
    eng.infer("g", x)
    jeng.infer("g", x)
    rng = np.random.default_rng(9)
    for i in range(6):  # alternate value-only and structural deltas
        coo = jeng._graphs["g"].coo
        delta = (_value_delta(coo, 8, rng) if i % 2 == 0
                 else _structural_delta(N_NODES, 8, rng))
        rep = eng.update_graph("g", delta)
        jrep = jeng.update_graph("g", delta)
        assert isinstance(rep, UpdateReport)
        for f in REPORT_FIELDS:
            assert getattr(rep, f) == getattr(jrep, f), (i, f)
        assert rep.drift == pytest.approx(jrep.drift)
        assert rep.repaired and not rep.fell_back
        rec, jrec = eng._graphs["g"], jeng._graphs["g"]
        _same_sched(rec.sched, jrec.sched)
        assert np.array_equal(rec.per_row, jrec.per_row)
        for a, b in zip(rec.coo[:3], jrec.coo[:3]):
            assert np.array_equal(tfmt.to_numpy(a), np.asarray(b))
    assert eng.counters["graph_updates"] == jeng.counters["graph_updates"] == 6
    got = eng.infer("g", x).numpy()
    np.testing.assert_allclose(got, np.asarray(jeng.infer("g", x)), atol=TOL)
    eng.drain_persists()
    jeng.drain_persists()
    assert eng._graphs["g"].fingerprint == jeng._graphs["g"].fingerprint


def test_update_chain_through_the_kernels_plan(tmp_path, monkeypatch):
    """The card's executor path on the host (the kernel wrappers take their
    plain versions for CPU tensors): after every update of the chain the
    engine's upload equals a cold plan of its schedule, no update re-plans
    the whole schedule, value updates are scoped, and the logits match the
    reference engine and a cold admission of the final graph."""
    monkeypatch.setattr(texe, "_runs_kernels", lambda device: True)
    monkeypatch.setattr(texe, "SCOPED_UPLOAD_MIN_BYTES", 0)
    eng, jeng, params = _engines(tmp_path, 17)
    x = _x(17)
    eng.infer("g", x)
    old = eng._graphs["g"].executor
    before = _snapshot(old._steps[:5])
    plan_calls = [0]
    kernel_plan = spmm_cuda.kernel_plan

    def counted(sched):
        plan_calls[0] += 1
        return kernel_plan(sched)

    monkeypatch.setattr(spmm_cuda, "kernel_plan", counted)
    rng = np.random.default_rng(17)
    for i in range(6):
        coo = jeng._graphs["g"].coo
        delta = (_value_delta(coo, 8, rng) if i % 2 == 0
                 else _structural_delta(N_NODES, 8, rng))
        rep = eng.update_graph("g", delta)
        jrep = jeng.update_graph("g", delta)
        assert rep.repaired and (rep.scoped_upload or i % 2 == 1)
        assert rep.steps_reused == jrep.steps_reused
        rec = eng._graphs["g"]
        cold = kernel_plan(rec.sched)
        for name, t in zip(spmm_cuda.DEVICE_FIELDS, rec.executor._steps[:5]):
            assert np.array_equal(t.numpy(), cold[name]), (i, name)
        assert texe.device_step_arrays(rec.sched, CPU) is rec.executor._steps
    assert plan_calls[0] == 0
    _unchanged(old._steps[:5], before)
    got = eng.infer("g", x)
    np.testing.assert_allclose(got.numpy(), np.asarray(jeng.infer("g", x)), atol=TOL)
    rec = eng._graphs["g"]
    ident = _pinned_engine(tmp_path / "cold", rec.config)
    ident.add_graph("g", rec.coo, tgcn.params_from_jax(params, "cpu"))
    assert torch.equal(got, ident.infer("g", x))


def test_update_graph_value_lane_report(tmp_path):
    eng, _, _ = _engines(tmp_path, 8)
    x = _x(8)
    eng.infer("g", x)
    rng = np.random.default_rng(8)
    rep = eng.update_graph("g", _value_delta(eng._graphs["g"].coo, 8, rng))
    assert rep.repaired and not rep.fell_back and rep.scoped_upload
    assert rep.revision == 1
    assert rep.fingerprint == "" and rep.lineage != ""
    sched = eng._graphs["g"].sched
    assert rep.steps_reused == sched.n_steps
    assert rep.windows_reused == rep.windows_total == sched.n_windows
    assert eng.counters["graph_updates"] == 1
    assert eng.counters["update_retunes"] == 0


def test_update_graph_chain_bit_identical_to_cold_admission(tmp_path):
    eng, _, params = _engines(tmp_path, 10)
    x = _x(10)
    eng.infer("g", x)
    rng = np.random.default_rng(10)
    old = eng._graphs["g"].executor
    before = _snapshot(_cpu_arrays(old))
    for i in range(6):
        coo = eng._graphs["g"].coo
        delta = (_value_delta(coo, 8, rng) if i % 2 == 0
                 else _structural_delta(N_NODES, 8, rng))
        rep = eng.update_graph("g", delta)
        assert rep.repaired and not rep.fell_back
    _unchanged(_cpu_arrays(old), before)  # the swap never wrote the old arrays
    got = eng.infer("g", x)
    rec = eng._graphs["g"]
    ident = _pinned_engine(tmp_path / "cold", rec.config)
    ident.add_graph("g", rec.coo, tgcn.params_from_jax(params, "cpu"))
    assert torch.equal(got, ident.infer("g", x))


def test_update_graph_drift_triggers_retune(tmp_path):
    eng, jeng, params = _engines(tmp_path, 11, repair_drift_threshold=1e-9)
    x = _x(11)
    eng.infer("g", x)
    rng = np.random.default_rng(11)
    delta = _value_delta(eng._graphs["g"].coo, 8, rng)
    rep = eng.update_graph("g", delta)
    jrep = jeng.update_graph("g", delta)
    assert not rep.repaired and rep.fingerprint != ""
    assert (rep.fingerprint, rep.lineage, rep.revision) == (
        jrep.fingerprint, jrep.lineage, jrep.revision)
    assert eng.counters["update_retunes"] == 1
    rec = eng._graphs["g"]
    assert rec.drift_nnz == 0
    assert rec.fingerprint == rep.fingerprint
    assert rec.lineage == rep.fingerprint
    got = eng.infer("g", x)
    ident = _pinned_engine(tmp_path / "cold", rec.config)
    ident.add_graph("g", rec.coo, tgcn.params_from_jax(params, "cpu"))
    assert torch.equal(got, ident.infer("g", x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jeng.infer("g", x)), atol=TOL)


def test_update_graph_errors_leave_state_unchanged(tmp_path):
    eng, _, _ = _engines(tmp_path, 12)
    x = _x(12)
    ref = eng.infer("g", x)
    with pytest.raises(UnknownGraphError):
        eng.update_graph("nope", tfmt.EdgeDelta(
            np.array([0]), np.array([0]), np.array([1.0], np.float32)))
    with pytest.raises(ValueError, match="out of bounds"):
        eng.update_graph("g", tfmt.EdgeDelta(
            np.array([N_NODES]), np.array([0]), np.array([1.0], np.float32)))
    assert eng._graphs["g"].revision == 0
    assert eng.counters["graph_updates"] == 0
    assert torch.equal(eng.infer("g", x), ref)


def test_async_persist_backfills_fingerprint_and_warm_restarts(tmp_path, monkeypatch):
    ta, _ = _graph(13)
    params = tgcn.params_from_jax(_params(13), "cpu")
    x = _x(13)
    eng = _engine(tmp_path)
    eng.add_graph("g", ta, params)
    eng.infer("g", x)
    rng = np.random.default_rng(13)
    rep = eng.update_graph("g", _value_delta(ta, 8, rng))
    assert rep.fingerprint == ""
    eng.drain_persists()
    rec = eng._graphs["g"]
    fp2 = registry.graph_fingerprint(rec.coo)
    assert rec.fingerprint == fp2
    registry.clear_caches()
    monkeypatch.setattr(runner, "measure_candidate",
                        lambda *a_, **k: pytest.fail("sweep on warm start"))
    monkeypatch.setattr(tsched, "build_balanced_schedule",
                        lambda *a_, **k: pytest.fail("rebuild on warm start"))
    eng2 = _engine(tmp_path)
    rep2 = eng2.add_graph("g", rec.coo, params)
    assert rep2.warm_start
    assert torch.equal(eng2.infer("g", x), eng.infer("g", x))


def test_update_graph_zero_gap_under_concurrent_infer(tmp_path):
    eng, _, _ = _engines(tmp_path, 14)
    x = _x(14)
    eng.infer("g", x)
    rng = np.random.default_rng(14)
    stop = threading.Event()
    served, failures = [0], []

    def _background():
        while not stop.is_set():
            try:
                y = eng.infer("g", x)
                assert torch.isfinite(y).all()
                served[0] += 1
            except Exception as e:  # pragma: no cover - the bug under test
                failures.append(repr(e))
                return

    th = threading.Thread(target=_background, daemon=True)
    th.start()
    try:
        for i in range(4):
            coo = eng._graphs["g"].coo
            delta = (_value_delta(coo, 8, rng) if i % 2 == 0
                     else _structural_delta(N_NODES, 8, rng))
            eng.update_graph("g", delta)
    finally:
        stop.set()
        th.join(timeout=60.0)
    assert not th.is_alive()
    assert not failures, failures
    assert served[0] > 0


def test_update_graph_on_evicted_graph_is_host_only(tmp_path):
    eng, _, params = _engines(tmp_path, 15)
    x = _x(15)
    eng.infer("g", x)
    eng._evict(eng._graphs["g"])
    assert eng._graphs["g"].executor is None
    bytes_before = eng.device_bytes_in_use
    rep = eng.update_graph("g", _value_delta(eng._graphs["g"].coo, 8,
                                             np.random.default_rng(15)))
    assert rep.repaired and not rep.scoped_upload
    assert eng._graphs["g"].executor is None
    assert eng.device_bytes_in_use == bytes_before
    got = eng.infer("g", x)  # re-admits the repaired schedule
    rec = eng._graphs["g"]
    ident = _pinned_engine(tmp_path / "cold", rec.config)
    ident.add_graph("g", rec.coo, tgcn.params_from_jax(params, "cpu"))
    assert torch.equal(got, ident.infer("g", x))


def test_update_keeps_byte_accounting(tmp_path):
    eng, _, _ = _engines(tmp_path, 16)
    eng.infer("g", _x(16))
    rng = np.random.default_rng(16)
    for i in range(3):
        delta = _structural_delta(N_NODES, 12, rng)
        eng.update_graph("g", delta)
        rec = eng._graphs["g"]
        assert rec.bytes == rec.executor.device_bytes + sum(
            int(w.nbytes) for w in rec.params.values())
        assert eng.device_bytes_in_use == rec.bytes
        assert eng.placer.used[0] == rec.bytes


# ---------------------------------------------------------------------------
# lock discipline under the reference's runtime race assertions
# ---------------------------------------------------------------------------


def _run_threads(workers):
    errors = []

    def wrap(fn):
        def run():
            try:
                fn()
            except Exception as e:  # pragma: no cover - surfaced via assert
                errors.append(e)
        return run

    threads = [threading.Thread(target=wrap(fn), name=name) for name, fn in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    assert not any(t.is_alive() for t in threads), "fuzz worker hung"
    return errors


def _fuzz_engine(tmp_path):
    ta, _ = _graph(7, n=120, density=0.04)
    cfg = tgcn.GCNConfig(12, 8, 4)
    params = tgcn.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    eng = _engine(tmp_path)
    eng.add_graph("g", ta, params)
    x = np.random.default_rng(7).random((120, 12)).astype(np.float32)
    return eng, ta, x


def test_thread_fuzz_clean(tmp_path):
    eng, a, x = _fuzz_engine(tmp_path)
    rounds = 12

    def updater():
        rng = np.random.default_rng(1)
        for _ in range(rounds):
            eng.update_graph("g", _value_delta(a, 6, rng))

    def server():
        for _ in range(rounds):
            assert tuple(eng.infer("g", x).shape) == (120, 4)

    def poller():
        for _ in range(rounds):
            eng.submit("g", x)
            eng.poll()
        eng.flush()

    with guarded(eng) as g:
        errors = _run_threads(
            [("updater", updater), ("server", server), ("poller", poller)])
        eng.drain_persists()
    assert errors == []
    assert [v.render() for v in g.violations] == []


def test_thread_fuzz_catches_seeded_unguarded_write(tmp_path):
    eng, _, x = _fuzz_engine(tmp_path)
    rec = eng._graphs["g"]

    def rogue():
        rec.bytes = rec.bytes + 0  # unguarded write to a published record

    def server():
        for _ in range(4):
            eng.infer("g", x)

    with guarded(eng) as g:
        errors = _run_threads([("rogue", rogue), ("server", server)])
    assert errors == []
    assert any(v.cls == "_Resident" and v.field == "bytes" and v.lock == "_swap_lock"
               for v in g.violations), [v.render() for v in g.violations]


def test_concurrent_update_and_infer_outputs_stay_valid(tmp_path):
    eng, a, x = _fuzz_engine(tmp_path)
    stop = threading.Event()

    def updater():
        rng = np.random.default_rng(2)
        while not stop.is_set():
            eng.update_graph("g", _value_delta(a, 4, rng))

    outs = []

    def server():
        try:
            for _ in range(20):
                outs.append(eng.infer("g", x))
        finally:
            stop.set()

    errors = _run_threads([("updater", updater), ("server", server)])
    eng.drain_persists()
    assert errors == []
    assert len(outs) == 20
    for out in outs:
        assert tuple(out.shape) == (120, 4) and torch.isfinite(out).all()


def test_engine_annotations_are_registered():
    """The port's engine carries the reference's lock annotations for the
    fields it has, so the static and runtime checks cover it."""
    from repro.analysis import locks
    from repro.analysis.modules import ModuleInfo

    with open(ge.__file__, encoding="utf-8") as fh:
        mod = ModuleInfo(ge.__file__, fh.read())
    guarded_fields = locks.collect_guarded(mod)
    assert guarded_fields["_Resident"] == dict.fromkeys(
        ("fingerprint", "params", "executor", "bytes", "replicas", "revision"),
        "_swap_lock")
    assert guarded_fields["GCNServingEngine"] == {
        "_persist_thread": "_persist_spawn_lock"}
    assert locks.lock_declaration_order(mod) == ["_swap_lock", "_persist_spawn_lock"]
