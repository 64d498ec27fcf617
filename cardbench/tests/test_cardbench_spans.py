"""The readers of the program's own ranges (``spans.py`` and the metrics
that use it) on made-up records: what a range holds on the card does not
depend on the kernels' names, an operation counts once, queue waits form
one union, a wait open at the profiler's stop, and nothing to read."""

import pytest

from cardbench import spans, spec, work
from cardbench.trace import DEVICE, DEVICE_SPAN, HOST, Event

DIMS = [602, 128, 41]
N, NNZ = 232_965, 22_942_754
GEMM = "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n"
WINDOW = "void spmm_step_kernel<4, 2>(int2 const*)"
EPILOGUE = "epilogue_kernel(float const*)"


def _batch(t0, gemm=GEMM, window=WINDOW, epilogue=EPILOGUE):
    """One batch of one layer on the card, as the program's ranges show it:
    the stack copy, X·W, a layout copy, the SpMM's window and epilogue, a
    layout copy back, and a ReLU in no range of its own."""
    ops = [("gcn_engine.stack", "CatArrayBatchedCopy", 0, 40),
           ("executor.xw", gemm, 40, 140),
           ("executor.layout", "elementwise_kernel", 140, 160),
           ("executor.spmm", window, 160, 460),
           ("executor.spmm", epilogue, 460, 500),
           ("executor.layout", "elementwise_kernel", 500, 520)]
    ev = [Event("gcn_engine.dispatch", HOST, t0, t0 + 30),
          Event("gcn_engine.await", HOST, t0 + 30, t0 + 540),
          Event("vectorized_elementwise_kernel", DEVICE, t0 + 520, t0 + 530)]
    for rng, op, s, t in ops:
        ev += [Event(rng, DEVICE_SPAN, t0 + s, t0 + t),
               Event(op, DEVICE, t0 + s, t0 + t)]
    return ev


def _events(**names):
    return _batch(0.0, **names) + _batch(1000.0, **names)


def _run(events, **over):
    kw = dict(setup_s=42.0, window_s=0.002, completed_in_window=8,
              latencies_s=[0.01], batch_sizes=[4, 4], events=events,
              fields=dict(n=N, nnz=NNZ, dims=DIMS, schedule_utilization=0.9375))
    kw.update(over)
    return spec.Run(**kw)


def _read(name, run):
    return spec.reader(name)(run)


RANGE_READERS = ["stack_ms_per_request", "xw_range_ms_per_request",
                 "layout_ms_per_request", "spmm_range_roofline",
                 "queue_wait_p95_ms", "idle_queued_share"]


def test_device_time_by_range():
    run = _run(_events())
    assert _read("stack_ms_per_request", run) == pytest.approx(0.08 / 8)
    assert _read("xw_range_ms_per_request", run) == pytest.approx(0.2 / 8)
    assert _read("layout_ms_per_request", run) == pytest.approx(0.08 / 8)
    bound = 2 * work.batch_spmm_bound_s(N, NNZ, DIMS, 4)
    assert _read("spmm_range_roofline", run) == pytest.approx(100 * bound / 680e-6)
    # the name-matched readers agree where the kernels keep their names
    assert _read("xw_ms_per_request", run) == _read("xw_range_ms_per_request", run)
    assert _read("spmm_roofline", run) == _read("spmm_range_roofline", run)


def test_renamed_kernels_leave_the_range_readers_unchanged():
    named = _run(_events())
    renamed = _run(_events(gemm="awb_sparse_x_product", window="awb_window_v2",
                           epilogue="awb_fold"))
    for name in RANGE_READERS[:4]:
        assert _read(name, renamed) == _read(name, named), name
    assert _read("xw_ms_per_request", renamed) is None
    assert _read("spmm_roofline", renamed) is None


def test_an_operation_counts_once_under_the_range_asked_for():
    ev = [Event("gcn_engine.dispatch", DEVICE_SPAN, 0, 100),
          Event("executor.layout", DEVICE_SPAN, 10, 50),
          Event("executor.layout", DEVICE_SPAN, 20, 60),  # overlaps the first
          Event("copy", DEVICE, 25, 35),
          Event("relu", DEVICE, 70, 80),
          Event("late", DEVICE, 95, 140)]  # its midpoint lies past every span
    assert spans.device_us_within(ev, "executor.layout") == 10.0
    assert spans.device_us_within(ev, "gcn_engine.dispatch") == 20.0
    assert spans.device_us_within(ev, "executor.xw") is None
    # a range that ran and launched nothing on the card (the layout of a
    # batch of one is a view) holds no device time; without device work
    # (a run on the CPU) it reads nothing
    ev.append(Event("executor.xw", HOST, 0, 5))
    assert spans.device_us_within(ev, "executor.xw") == 0.0
    assert spans.device_us_within(ev[-1:], "executor.xw") is None


def _queued(*intervals, busy=()):
    ev = [Event("gcn_engine.queued", HOST, s, t) for s, t in intervals]
    ev += [Event("k", DEVICE, s, t) for s, t in busy]
    return ev


def test_overlapping_queue_waits_form_one_union():
    # three waits that overlap without nesting: 0..400 in all; the card is
    # busy 100..150 and 350..500, so 300 µs of the union find it idle
    ev = _queued((0, 200), (50, 300), (250, 400), busy=[(100, 150), (350, 500)])
    run = _run(ev, window_s=0.001)
    assert _read("idle_queued_share", run) == pytest.approx(30.0)
    assert _read("idle_queued_share", run) <= _read("device_idle_share", run)
    # nearest rank of three: the longest
    assert _read("queue_wait_p95_ms", run) == pytest.approx(0.25)


def test_a_wait_open_at_the_profilers_stop_reads_short():
    """The profiler ends such a range where the range it opened in ended:
    it counts with that duration, as documented in ``spans``."""
    ev = _queued(*[(i * 100, i * 100 + 50) for i in range(19)], busy=[(0, 10)])
    ev += [Event("cardbench.submit", HOST, 2000, 2005),
           Event("gcn_engine.queued", HOST, 2001, 2005)]
    run = _run(ev)
    assert len(spans.host_spans(ev, "gcn_engine.queued")) == 20
    assert _read("queue_wait_p95_ms", run) == pytest.approx(0.05)
    assert _read("idle_queued_share", run) == pytest.approx(
        100 * (19 * 50 - 10 + 4) / 1e6 / 0.002)


@pytest.mark.parametrize("name", RANGE_READERS)
def test_each_reader_reads_nothing_without_its_ranges(name):
    assert _read(name, _run(None)) is None
    kernels_only = [e for e in _events() if e.kind == DEVICE]
    assert _read(name, _run(kernels_only)) is None


@pytest.mark.parametrize("name", RANGE_READERS[:3])
def test_per_request_readers_read_nothing_without_answers(name):
    assert _read(name, _run(_events(), completed_in_window=0)) is None


def test_idle_queued_share_reads_nothing_without_device_work():
    assert _read("idle_queued_share", _run(_queued((0, 100)))) is None
    assert _read("queue_wait_p95_ms", _run(_queued((0, 100)))) == pytest.approx(0.1)


@pytest.mark.parametrize("spans_, cover, want", [
    ([(0, 10)], [], 10.0),
    ([(0, 10)], [(0, 10)], 0.0),
    ([(0, 10)], [(2, 4), (6, 8)], 6.0),
    ([(0, 10), (20, 30)], [(5, 25)], 10.0),
    ([(10, 20)], [(0, 5), (30, 40)], 10.0),
    ([(0, 10)], [(-5, 3), (8, 50)], 5.0),
])
def test_uncovered_length(spans_, cover, want):
    assert spans.uncovered_us(spans_, cover) == want


def test_union_merges_overlapping_and_touching_intervals():
    assert spans.union([(5, 7), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 7)]
    assert spans.union([]) == []
