"""The port's profiler ranges (``repro_torch.tracing``) in the serving
engine and the executor, on the CPU under ``torch.profiler``: their names
and nesting, one ``gcn_engine.queued`` range per accepted request (none for
a rejected or shed one), a range kept open across a failed dispatch and
closed by ``remove_graph``, nothing opened with no profiler recording, and
the same logits with the profiler on and off."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import tracing
from repro_torch.core import gcn
from repro_torch.core.executor import FAULTS
from repro_torch.graphs import synth
from repro_torch.serving import gcn_engine as ge
from repro_torch.serving.errors import FlushError, RequestFailure
from repro_torch.serving.types import ACCEPTED, REJECTED, SHED

N_NODES, N_FEATS, HIDDEN, N_CLASSES = 200, 12, 8, 4
SWEEP = [dict(nnz_per_step=64, rows_per_window=32, cols_per_block=None,
              window_nnz=None, routing="gather")]
FAST_KW = dict(iters=1, warmup=1, sweep=SWEEP, bf16_report=False)
QUEUED = "gcn_engine.queued"
PROGRAM = (QUEUED, "gcn_engine.dispatch", "gcn_engine.stack", "gcn_engine.await",
           "executor.xw", "executor.spmm", "executor.layout")


@pytest.fixture(autouse=True)
def _no_faults():
    FAULTS.clear()
    yield
    FAULTS.clear()


@pytest.fixture
def served(tmp_path):
    """An engine on the CPU with one small graph ``g`` admitted, and a
    function that makes request ``i``'s features."""
    def make(**kw):
        a = synth.power_law_adjacency(N_NODES, 0.03, 0.9, seed=0)
        params = gcn.init_params(gcn.GCNConfig(N_FEATS, HIDDEN, N_CLASSES),
                                 torch.Generator().manual_seed(0), device="cpu")
        eng = ge.GCNServingEngine(store_root=tmp_path, device="cpu",
                                  autotune_kwargs=FAST_KW, **kw)
        eng.add_graph("g", a, params)
        return eng
    return make


def x(i: int) -> torch.Tensor:
    return torch.rand((N_NODES, N_FEATS), generator=torch.Generator().manual_seed(i))


def _profile():
    return profile(activities=[ProfilerActivity.CPU])


def _ranges(prof, name):
    """``(start, end)`` of each host range ``name``, in order of start."""
    return sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.name == name)


def _within(inner, outers):
    return any(s <= inner[0] and inner[1] <= t for s, t in outers)


@pytest.fixture
def entered(monkeypatch):
    """The ``(name, args)`` of every range opened, through the profiler's
    ``_record_function_enter_new`` (``record_function`` opens through it
    too)."""
    calls = []
    orig = torch.ops.profiler._record_function_enter_new

    def enter(name, args=None):
        calls.append((name, args))
        return orig(name, args)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", enter)
    return calls


def test_range_names_and_nesting(served):
    eng = served(max_batch=2)
    with _profile() as prof:
        eng.submit("g", x(0))
        assert eng.submit("g", x(1)).accepted  # fills the batch: served here
    r = {name: _ranges(prof, name) for name in PROGRAM}
    assert {k: len(v) for k, v in r.items()} == {
        QUEUED: 2, "gcn_engine.dispatch": 1, "gcn_engine.stack": 1,
        "gcn_engine.await": 1, "executor.xw": 2, "executor.spmm": 2,
        "executor.layout": 4}
    dispatch = r["gcn_engine.dispatch"]
    for name in ("gcn_engine.stack", "executor.xw", "executor.spmm", "executor.layout"):
        assert all(_within(s, dispatch) for s in r[name]), name
    assert not _within(r["gcn_engine.await"][0], dispatch)
    assert dispatch[0][1] <= r["gcn_engine.await"][0][0]
    # each layer: X·W, layout, SpMM, layout, in that order and apart
    layer = sorted(r["executor.xw"] + r["executor.spmm"] + r["executor.layout"])
    names = [n for s in layer for n in PROGRAM if s in r[n]]
    assert names == ["executor.xw", "executor.layout", "executor.spmm",
                     "executor.layout"] * 2
    assert all(a[1] <= b[0] for a, b in zip(layer, layer[1:]))
    # the queue wait ends once its batch is dispatched, before the await
    for q in r[QUEUED]:
        assert dispatch[0][1] <= q[1] <= r["gcn_engine.await"][0][0]


def test_a_stacked_batch_opens_no_stack_range(served):
    eng = served()
    with _profile() as prof:
        eng.serve_batch("g", torch.stack([x(0), x(1)]))
        eng.serve_batch("g", [x(0), x(1)])
    assert len(_ranges(prof, "gcn_engine.dispatch")) == 2
    assert len(_ranges(prof, "gcn_engine.stack")) == 1
    assert not _ranges(prof, QUEUED)  # a direct batch waits on no queue


@pytest.mark.parametrize("path", ["serve_batch", "flush"])
def test_a_list_batch_opens_one_stack_range_with_nothing_run_in_it(served, path):
    eng = served()
    xs = [x(0), x(1)]
    with _profile() as prof:
        if path == "serve_batch":
            eng.serve_batch("g", xs)
        else:
            for xi in xs:
                eng.submit("g", xi)
            eng.flush()
    stack = _ranges(prof, "gcn_engine.stack")
    assert len(stack) == 1
    inside = {e.name for e in prof.events() if e.name.startswith("aten::")
              and _within((e.time_range.start, e.time_range.end), stack)}
    copies = ("stack", "cat", "copy", "clone", "empty")
    assert not {n for n in inside if any(w in n for w in copies)}, inside


def test_one_queued_range_per_accepted_request_with_its_rid(served, entered):
    eng = served(max_batch=4)
    with _profile() as prof:
        rids = [eng.submit("g", x(i)).rid for i in range(10)]
        eng.flush()
    assert len(_ranges(prof, QUEUED)) == 10
    assert sorted(a for n, a in entered if n == QUEUED) == sorted(
        f"rid={r}" for r in rids)
    # the dispatches name their requests: two full batches, then the rest
    assert [a for n, a in entered if n == "gcn_engine.dispatch"] == [
        "rids=0,1,2,3", "rids=4,5,6,7", "rids=8,9"]


def test_rejected_and_shed_requests_open_no_range(served, entered):
    eng = served(max_queue_depth=1, shed_unmeetable=True)
    eng._svc_ewma["g"] = 1.0
    eng._svc_req_ewma["g"] = 1.0 / 8
    now = 1000.0
    with _profile() as prof:
        assert eng.submit("g", x(0), deadline_s=0.5, now=now).status == SHED
        assert eng.submit("g", x(1), deadline_s=10.0, now=now).status == ACCEPTED
        assert eng.submit("g", x(2), deadline_s=10.0, now=now).status == REJECTED
        eng.flush()
    assert len(_ranges(prof, QUEUED)) == 1
    assert [a for n, a in entered if n == QUEUED] == ["rid=0"]


def test_a_request_shed_at_dispatch_ends_its_wait(served):
    eng = served(shed_unmeetable=True)
    now = 1000.0
    with _profile() as prof:
        assert eng.submit("g", x(0), deadline_s=0.05, now=now).accepted
        held = list(eng._pending["g"])  # a request's range also ends when it is freed
        assert eng.poll(now=now + 0.2) == {}
        with record_function("after"):
            pass
    (q,) = _ranges(prof, QUEUED)
    assert q[1] <= _ranges(prof, "after")[0][0] and len(held) == 1
    assert not _ranges(prof, "gcn_engine.dispatch")


def test_the_wait_stays_open_across_a_failed_dispatch(served, monkeypatch):
    eng = served(max_dispatch_retries=1)
    monkeypatch.setattr(ge, "_sleep", lambda s: None)
    with _profile() as prof:
        eng.submit("g", x(0))
        eng.submit("g", x(1))
        FAULTS.arm("dispatch", times=99, graph="g")
        with pytest.raises(FlushError):
            eng.flush()
        FAULTS.clear()
        out = eng.flush()["g"]
    assert out.shape == (2, N_NODES, N_CLASSES)
    dispatch = _ranges(prof, "gcn_engine.dispatch")
    assert len(dispatch) == 3  # two failed attempts, then the one that served
    queued = _ranges(prof, QUEUED)
    assert len(queued) == 2
    for q in queued:
        assert q[0] <= dispatch[0][0] and dispatch[2][1] <= q[1]


def test_remove_graph_ends_the_wait_of_what_it_drops(served):
    eng = served()
    with _profile() as prof:
        eng.submit("g", x(0))
        eng.submit("g", x(1))
        held = list(eng._pending["g"])  # a request's range also ends when it is freed
        with pytest.raises(RequestFailure):
            eng.remove_graph("g")
        with record_function("after"):
            pass
    assert len(held) == 2
    queued = _ranges(prof, QUEUED)
    assert len(queued) == 2
    assert all(q[1] <= _ranges(prof, "after")[0][0] for q in queued)


def test_a_wait_open_when_the_profiler_stops(served):
    """Such a range reads as ending where the range it was opened in ended
    (the benchmark's own ``cardbench.submit``), or at the stop if it was
    opened in none; closing it later is harmless."""
    eng = served()
    with _profile() as prof:
        with record_function("client"):
            eng.submit("g", x(0))
        eng.submit("g", x(1))
        with record_function("last"):
            pass
    inside, outside = _ranges(prof, QUEUED)
    assert inside[1] == _ranges(prof, "client")[0][1]
    assert outside[1] >= _ranges(prof, "last")[0][1]
    assert eng.flush()["g"].shape == (2, N_NODES, N_CLASSES)


def test_no_range_opens_without_a_profiler(served, entered):
    eng = served(max_batch=2)
    assert tracing.open_span(QUEUED, {"rid": 1}) is None
    tracing.close_span(None)
    eng.submit("g", x(0))
    eng.submit("g", x(1))
    eng.submit("g", x(2))
    eng.poll()
    eng.flush()
    eng.serve_batch("g", [x(3)])
    eng.submit("g", x(4))
    with pytest.raises(RequestFailure):
        eng.remove_graph("g")
    assert entered == []


def test_logits_are_the_same_with_the_profiler_on_and_off(served):
    def serve():
        eng = served(max_batch=3)
        for i in range(5):
            eng.submit("g", x(i))
        return torch.cat([eng.flush()["g"], eng.serve_batch("g", [x(5), x(6)])])

    off = serve()
    with _profile():
        on = serve()
    assert torch.equal(on, off)


@pytest.mark.parametrize("args, want", [
    (None, None), ({}, None), ({"rid": 7}, "rid=7"), ({"rids": [3, 4]}, "rids=3,4"),
    ({"rids": None}, None), ({"a": 1, "b": [2, 3]}, "a=1 b=2,3")])
def test_range_arguments(args, want, entered):
    with _profile() as prof:
        with tracing.span("s", args):
            pass
        tracing.close_span(tracing.open_span("o", args))
    assert entered == [("s", want), ("o", want)]
    assert len(_ranges(prof, "s")) == len(_ranges(prof, "o")) == 1
