"""The port's host-side models against the JAX package's, exactly: the PE
simulator (``core/pesim``), the §IV autotuner (``core/autotuner``), the
workload profiler (``core/profiler``) and the contiguous step split
(``sharding/schedule_shard``). Mirrors ``tests/test_autotuner.py`` with its
invariants, and holds every output to the reference's with
``np.array_equal``/``==``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import autotuner as jtuner  # noqa: E402
from repro.core import pesim as jpesim  # noqa: E402
from repro.core import profiler as jprof  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.graphs import synth as jsynth  # noqa: E402
from repro.sharding import schedule_shard as jshard  # noqa: E402
from repro_torch.core import autotuner as ttuner  # noqa: E402
from repro_torch.core import pesim as tpesim  # noqa: E402
from repro_torch.core import profiler as tprof  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.graphs import synth as tsynth  # noqa: E402
from repro_torch.sharding import schedule_shard as tshard  # noqa: E402


def zipf_loads(n_rows, alpha, seed, total=5000):
    rng = np.random.default_rng(seed)
    w = np.arange(1, n_rows + 1, dtype=np.float64) ** (-alpha)
    w /= w.sum()
    loads = np.maximum(1, np.round(w * total))
    rng.shuffle(loads)
    return loads


def _same_run(a, b):
    """Two ``run_autotuning`` results are equal, array for array."""
    (sa, la), (sb, lb) = a, b
    assert np.array_equal(sa.row_to_pe, sb.row_to_pe)
    assert sorted(sa.split_rows) == sorted(sb.split_rows)
    for row, (pes, fr) in sa.split_rows.items():
        assert np.array_equal(pes, sb.split_rows[row][0])
        assert np.array_equal(fr, sb.split_rows[row][1])
    assert sa.tracked == sb.tracked
    assert [dataclasses.astuple(r) for r in la] == [dataclasses.astuple(r) for r in lb]


# ---- pesim -----------------------------------------------------------------


@pytest.mark.parametrize("n,hops,seed", [
    (4, 0, 1), (17, 1, 2), (64, 2, 3), (120, 3, 4), (200, 4, 5), (9, 4, 6)])
def test_interval_makespan_bounds_and_parity(n, hops, seed):
    load = zipf_loads(n, 1.0, seed)
    mk = tpesim.interval_makespan(load, hops)
    assert mk == jpesim.interval_makespan(load, hops)
    assert mk >= load.sum() / n - 1e-9
    assert mk <= load.max() + 1e-9
    if hops == 0:
        assert mk == load.max()
    assert tpesim.utilization(load, hops) == jpesim.utilization(load, hops)
    assert np.array_equal(tpesim.smoothed_finish_times(load, hops),
                          jpesim.smoothed_finish_times(load, hops))


@pytest.mark.parametrize("n,seed", [(8, 0), (50, 1), (100, 2)])
def test_makespan_monotone_in_hops(n, seed):
    load = zipf_loads(n, 1.2, seed)
    mks = [tpesim.interval_makespan(load, h) for h in range(4)]
    assert all(a >= b - 1e-9 for a, b in zip(mks, mks[1:]))


def test_utilization_balanced_is_one():
    assert abs(tpesim.utilization(np.full(16, 10.0), 0) - 1.0) < 1e-9
    assert tpesim.utilization(np.zeros(4), 2) == 1.0


def test_assignment_helpers_match_reference():
    row_nnz = zipf_loads(100, 1.1, 3)
    a = tpesim.initial_assignment(100, 7)
    assert np.array_equal(a, jpesim.initial_assignment(100, 7))
    a = a.copy()
    a[5] = -1
    split = {5: (np.array([1, 2]), np.array([0.25, 0.75]))}
    assert np.array_equal(tpesim.loads_from_assignment(row_nnz, a, 7, split),
                          jpesim.loads_from_assignment(row_nnz, a, 7, split))


# ---- autotuner --------------------------------------------------------------


def test_work_conservation():
    row_nnz = zipf_loads(600, 1.1, 0)
    design = ttuner.designs_for("cora")["D"]
    run = ttuner.run_autotuning(row_nnz, 64, design, n_rounds=8)
    np.testing.assert_allclose(run[0].loads(row_nnz, 64).sum(), row_nnz.sum(),
                               rtol=1e-9)
    _same_run(run, jtuner.run_autotuning(row_nnz, 64, jtuner.designs_for("cora")["D"],
                                         n_rounds=8))


@pytest.mark.parametrize("dataset", ["cora", "nell"])
def test_design_ordering(dataset):
    row_nnz = zipf_loads(2000, 1.1, 1, total=40000)
    utils = {}
    for name, cfg in ttuner.designs_for(dataset).items():
        utils[name], log = ttuner.converged_utilization(row_nnz, 256, cfg)
        want, jlog = jtuner.converged_utilization(
            row_nnz, 256, jtuner.designs_for(dataset)[name])
        assert utils[name] == want
        assert [dataclasses.astuple(r) for r in log] == [
            dataclasses.astuple(r) for r in jlog]
    assert utils["baseline"] < utils["A"] <= utils["B"] + 0.05
    assert utils["baseline"] < utils["C"]
    assert utils["D"] > 2 * utils["baseline"]


def test_convergence_fig17():
    row_nnz = zipf_loads(1500, 1.2, 2, total=30000)
    run = ttuner.run_autotuning(row_nnz, 128, ttuner.designs_for("nell")["D"],
                                n_rounds=12)
    log = run[1]
    assert log[-1].utilization > log[0].utilization
    tail = [r.utilization for r in log[-3:]]
    assert max(tail) - min(tail) < 0.1
    _same_run(run, jtuner.run_autotuning(row_nnz, 128, jtuner.designs_for("nell")["D"],
                                         n_rounds=12))


def test_evil_row_triggers_remap():
    row_nnz = np.ones(512)
    row_nnz[7] = 2000.0
    run = ttuner.run_autotuning(row_nnz, 64, ttuner.designs_for("cora")["D"],
                                n_rounds=6)
    assert 7 in run[0].split_rows
    assert sum(r.n_remaps for r in run[1]) >= 1
    _same_run(run, jtuner.run_autotuning(row_nnz, 64, jtuner.designs_for("cora")["D"],
                                         n_rounds=6))


def test_total_cycles_reuses_converged_config():
    row_nnz = zipf_loads(800, 1.0, 3)
    design = ttuner.designs_for("cora")["D"]
    few = ttuner.total_cycles(row_nnz, 64, design, n_output_cols=16)
    many = ttuner.total_cycles(row_nnz, 64, design, n_output_cols=160)
    assert few < many < few * 10.5
    jdesign = jtuner.designs_for("cora")["D"]
    assert many == jtuner.total_cycles(row_nnz, 64, jdesign, n_output_cols=160)


def test_autotuner_agrees_with_oracle_schedule():
    ds = tsynth.make_dataset("nell", scale=16, device="cpu")
    rn = np.bincount(ds.adj.row.numpy(), minlength=ds.num_nodes).astype(np.float64)
    design = ttuner.designs_for("nell")["D"]
    tuner_util, _ = ttuner.converged_utilization(rn, 128, design)
    sched = tsched.build_balanced_schedule(ds.adj, 64, 32)
    assert tuner_util > 0.55 and sched.utilization > 0.85
    base_util, _ = ttuner.converged_utilization(
        rn, 128, ttuner.designs_for("nell")["baseline"])
    naive = tsched.build_naive_schedule(ds.adj, 64, 32)
    assert tuner_util > base_util and sched.utilization > naive.utilization
    jrn = np.bincount(np.asarray(jsynth.make_dataset("nell", scale=16).adj.row),
                      minlength=ds.num_nodes).astype(np.float64)
    assert np.array_equal(rn, jrn)
    assert tuner_util == jtuner.converged_utilization(
        jrn, 128, jtuner.designs_for("nell")["D"])[0]


# ---- profiler and the step split --------------------------------------------


@pytest.mark.parametrize("name,scale", [("cora", 4), ("pubmed", 16), ("nell", 16)])
def test_profiler_reports_match_reference(name, scale):
    ta = tsynth.make_dataset(name, scale=scale, device="cpu").adj
    ja = jsynth.make_dataset(name, scale=scale).adj
    assert (dataclasses.asdict(tprof.profile_matrix(ta, name))
            == dataclasses.asdict(jprof.profile_matrix(ja, name)))
    ts = tsched.build_balanced_schedule(ta, 64, 32)
    js = jsched.build_balanced_schedule(ja, 64, 32)
    assert tprof.schedule_report(ts) == jprof.schedule_report(js)
    for d in (1, 2, 3, 8):
        assert np.array_equal(tprof.device_loads(ts, d), jprof.device_loads(js, d))
        assert tprof.shard_report(ts, d) == jprof.shard_report(js, d)
        assert np.array_equal(tprof.naive_device_loads(ta, d),
                              jprof.naive_device_loads(ja, d))
    rn = np.bincount(ta.row.numpy(), minlength=ta.shape[0])
    assert tprof.gini_coefficient(rn) == jprof.gini_coefficient(rn)


@pytest.mark.parametrize("n_steps,n_devices", [(0, 1), (5, 8), (100, 3), (1001, 7)])
def test_step_split_matches_reference(n_steps, n_devices):
    assert np.array_equal(tshard.split_step_ranges(n_steps, n_devices),
                          jshard.split_step_ranges(n_steps, n_devices))
    counts = tshard.shard_step_counts(n_steps, n_devices)
    assert np.array_equal(counts, jshard.shard_step_counts(n_steps, n_devices))
    assert counts.sum() == n_steps and counts.max() - counts.min() <= 1
    with pytest.raises(ValueError):
        tshard.split_step_ranges(n_steps, 0)


def test_shard_nnz_matches_reference():
    ta = tsynth.power_law_adjacency(500, 0.03, 1.1, seed=2)
    ja = jsynth.power_law_adjacency(500, 0.03, 1.1, seed=2)
    ts = tsched.build_balanced_schedule(ta, 32, 16)
    js = jsched.build_balanced_schedule(ja, 32, 16)
    for d in (1, 2, 5, 16):
        got = tshard.shard_nnz(ts, d)
        assert np.array_equal(got, jshard.shard_nnz(js, d))
        assert got.sum() == int((ts.val != 0).sum())
