"""Each metric reader, and the trace's reductions, on made-up records."""

import pytest

from cardbench import spec, trace, work
from cardbench.trace import DEVICE, DEVICE_SPAN, HOST, Event

DIMS = [602, 128, 41]
N, NNZ = 232_965, 22_942_754


def _events():
    """Two batches: a GEMM, the SpMM window and epilogue, a copy; gaps where
    the host submits and polls."""
    ev = []
    for b, t0 in enumerate((0.0, 1000.0)):
        ev += [
            Event("cardbench.submit", HOST, t0, t0 + 400),
            Event("aten::stack", HOST, t0 + 10, t0 + 40),
            Event("cardbench.submit", DEVICE_SPAN, t0, t0 + 400),
            Event("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n", DEVICE, t0 + 50, t0 + 150),
            Event("void spmm_step_kernel<4, 2>(int2 const*)", DEVICE,
                  t0 + 150, t0 + 450),
            Event("epilogue_kernel(float const*)", DEVICE, t0 + 450, t0 + 500),
            Event("Memcpy DtoD (Device -> Device)", DEVICE, t0 + 480, t0 + 520),
            Event("cardbench.poll", HOST, t0 + 600, t0 + 700),
        ]
    return ev


def _run(events=None, **over):
    kw = dict(setup_s=42.0, window_s=0.002, completed_in_window=8,
              latencies_s=[0.01 * i for i in range(1, 21)], batch_sizes=[4, 4],
              events=events, fields=dict(n=N, nnz=NNZ, dims=DIMS,
                                         schedule_utilization=0.9375))
    kw.update(over)
    return spec.Run(**kw)


def _read(name, run):
    return spec.reader(name)(run)


def test_busy_union_and_idle_gaps():
    ev = _events()
    assert trace.busy_intervals(ev) == [(50.0, 520.0), (1050.0, 1520.0)]
    assert trace.busy_s(ev) == pytest.approx(940e-6)
    gaps = dict(trace.idle_gaps(ev))
    # 520..1050: midpoint 785 lies in no host range
    assert gaps == {"host idle": pytest.approx(530e-6)}
    ev.append(Event("aten::cat", HOST, 700, 900))
    assert dict(trace.idle_gaps(ev)) == {"aten::cat": pytest.approx(530e-6)}


def test_idle_gap_takes_the_innermost_open_range():
    ev = [Event("k", DEVICE, 0, 10), Event("k", DEVICE, 30, 40),
          Event("outer", HOST, 0, 100), Event("inner", HOST, 15, 25)]
    assert trace.idle_gaps(ev) == [["inner", pytest.approx(20e-6)]]


def test_breakdown_sums_by_name_largest_first():
    b = trace.breakdown(_events())
    assert b["device_ops"][0] == ["void spmm_step_kernel<4, 2>(int2 const*)",
                                  pytest.approx(600e-6)]
    assert len(b["device_ops"]) == 4 and len(b["idle_gaps"]) == 1


def test_end_to_end_readers():
    run = _run()
    assert _read("requests_per_s", run) == pytest.approx(4000.0)
    assert _read("latency_p95_ms", run) == pytest.approx(190.0)  # 19th of 20
    assert _read("setup_s", run) == 42.0
    assert _read("latency_p95_ms", _run(latencies_s=[])) is None


def test_counter_readers():
    run = _run()
    assert _read("batch_occupancy", run) == 4.0
    assert _read("schedule_utilization", run) == pytest.approx(93.75)
    assert _read("batch_occupancy", _run(batch_sizes=[])) is None


def test_trace_readers():
    run = _run(_events())
    assert _read("xw_ms_per_request", run) == pytest.approx(0.2 / 8)
    bound = 2 * work.batch_spmm_bound_s(N, NNZ, DIMS, 4)
    assert _read("spmm_roofline", run) == pytest.approx(100 * bound / 700e-6)
    assert _read("device_idle_share", run) == pytest.approx(100 * (1 - 940e-6 / 0.002))
    flops = 8 * work.request_flops(N, NNZ, DIMS)
    assert _read("mfu", run) == pytest.approx(100 * flops / (0.002 * 495e12))


@pytest.mark.parametrize("name", ["xw_ms_per_request", "spmm_roofline",
                                  "device_idle_share", "mfu"])
def test_trace_readers_read_nothing_without_a_trace(name):
    assert _read(name, _run()) is None


@pytest.mark.parametrize("name", ["xw_ms_per_request", "spmm_roofline",
                                  "device_idle_share"])
def test_trace_readers_read_nothing_without_their_kernels(name):
    host_only = [e for e in _events() if e.kind == HOST]
    assert _read(name, _run(host_only)) is None


@pytest.mark.parametrize("name", ["schedule_utilization", "mfu", "spmm_roofline",
                                  "spmm_range_roofline"])
def test_readers_of_the_gcn_fields_read_nothing_in_a_run_without_them(name):
    kw = dict(setup_s=42.0, window_s=0.002, completed_in_window=8,
              latencies_s=[0.01], batch_sizes=[4, 4], events=_events())
    assert _read(name, spec.Run(**kw)) is None


def test_every_metric_in_the_benchmark_has_a_reader():
    bench = spec.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_a_split_metric_reads_with_its_quantitys_reader():
    run = _run(_events())
    assert spec.reader("batch_occupancy.poisson")(run) == _read("batch_occupancy", run)
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric.poisson")


@pytest.mark.parametrize("cell, trace, want", [
    ("gcn-reddit.saturate", False, {"requests_per_s", "setup_s"}),
    ("gcn-reddit.poisson", False, {"latency_p95_ms", "setup_s"}),
    ("gcn-nell.saturate", True, {"latency_p95_ms.saturate", "batch_occupancy",
                                 "schedule_utilization", "xw_ms_per_request",
                                 "spmm_roofline", "device_idle_share", "mfu",
                                 "stack_ms_per_request", "xw_range_ms_per_request",
                                 "layout_ms_per_request", "spmm_range_roofline"}),
    ("gcn-reddit.poisson", True, {"batch_occupancy.poisson",
                                  "device_idle_share.poisson"}),
])
def test_each_cell_reports_its_metrics(cell, trace, want):
    bench = spec.benchmark()
    assert {m["name"] for m in spec.cell_metrics(bench, cell, trace)} == want
    for m in spec.cell_metrics(bench, cell, True):
        moved = {e["name"] for e in spec.cell_metrics(bench, cell, False)}
        assert m["moves"] in moved
