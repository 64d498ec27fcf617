"""The harness end to end on the CPU at a small size: a cell found by name,
a cell and a model family added as new files only, faults planted under the
timed path that ``correct`` has to catch, and the command's refusal without
a card."""

import json
import subprocess
import sys

import pytest
import torch

from cardbench import inputs, load, run, spec, sweep
from cardbench.tests import helpers
from repro_torch.core.executor import ScheduleExecutor

SECONDS = 0.3


def _run(root, seed=5, traced=False, cell=helpers.CELL):
    return run.run_cell(cell, seed, SECONDS, traced, root=root, device="cpu")


@pytest.mark.parametrize("traced", [False, True])
def test_a_cell_runs_and_is_correct(tmp_path, traced):
    r = _run(helpers.tiny_root(tmp_path), traced=traced)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    err = r["checks"]["logits_rel_err"]
    assert err["value"] <= err["limit"]
    if traced:
        assert r["metrics"]["batch_occupancy"]["value"] == 4.0
        assert 0 < r["metrics"]["schedule_utilization"]["value"] <= 100
        assert "busy_s" in r["device"] and "breakdown" in r
    else:
        assert set(r["metrics"]) == {"requests_per_s", "latency_p95_ms", "setup_s"}
        assert r["metrics"]["requests_per_s"]["value"] > 0


def test_a_config_a_mix_and_a_metric_added_as_files_are_found(tmp_path):
    root = helpers.tiny_root(tmp_path)
    bench_dir = root / "cardbench"
    cfg = helpers.tiny_config(name="toy", nodes=200, classes=3)
    cfg["serving"]["max_batch"] = 2
    (bench_dir / "configs" / "toy.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "trickle.json").write_text(json.dumps(
        {"arrivals": "closed", "clients_per_batch": 1, "deadline_s": 5.0,
         "warmup_rounds": 1}))
    (bench_dir / "metrics" / "answered.py").write_text(
        "def read(run):\n    return float(run.completed_in_window)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="toy",
                                 file="cardbench/configs/toy.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="toy.trickle",
                                   config="toy", traffic="trickle"))
    bench["per_layer"].append({
        "name": "answered", "unit": "requests", "better": "higher",
        "source": "host_clock", "layer": "serving/gcn_engine",
        "moves": "requests_per_s", "workloads": ["toy.trickle"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = _run(root, traced=True, cell="toy.trickle")
    assert r["correct"]
    assert set(r["metrics"]) == {"answered"}
    assert r["metrics"]["answered"]["value"] > 0


TOY_REFERENCE = """
import dataclasses

import torch


@dataclasses.dataclass
class Inputs:
    w0: torch.Tensor
    w1: torch.Tensor
    pool: list


def inputs(cfg, clients, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    f, h, c = cfg["features"], cfg["hidden"], cfg["classes"]
    w0 = torch.randn((f, h), generator=g, device=device)
    w1 = torch.randn((h, c), generator=g, device=device)
    pool = [torch.randn((cfg["rows"], f), generator=g, device=device)
            for _ in range(clients)]
    return Inputs(w0, w1, pool)


def check(inp, kept):
    err = float("inf") if not kept else 0.0
    for idx, out in kept:
        ref = torch.mm(torch.mm(inp.pool[idx], inp.w0).clamp_min(0.0), inp.w1)
        if out.shape != ref.shape:
            return {"out_rel_err": float("inf")}
        err = max(err, float((out - ref).abs().max() / ref.abs().max()))
    return {"out_rel_err": err}
"""

TOY_FAMILY = """
import torch

from cardbench import load


class Queue:
    def __init__(self, cfg, inp):
        self.w0, self.w1, self.rows = inp.w0, inp.w1, cfg["rows"]
        self.max_batch = cfg["serving"]["max_batch"]
        self.queue, self.done = [], []
        self.counting, self.sizes = False, []
        self.calls = load.Engine(self.submit, self.poll, self.flush)

    def _serve(self):
        xs, self.queue = self.queue, []
        if xs:
            out = torch.relu(torch.stack(xs) @ self.w0) @ self.w1
            self.done.append(out)
            if self.counting:
                self.sizes.append(len(xs))

    def submit(self, x):
        self.queue.append(x)
        if len(self.queue) >= self.max_batch:
            self._serve()
        return True

    def poll(self):
        if not self.done:
            return None
        out, self.done = torch.cat(self.done), []
        return out

    def flush(self):
        self._serve()
        return self.poll()

    def run_fields(self):
        return {"rows": self.rows}

    def close(self):
        self.queue = self.done = self.calls = None


def serve(cfg, mix, inp, device):
    return Queue(cfg, inp)
"""

#: a metric of the toy family's own, read from its ``run_fields``
TOY_METRIC = """
def read(run):
    rows = run.fields.get("rows")
    if rows is None or run.window_s <= 0:
        return None
    return rows * run.completed_in_window / run.window_s
"""

TOY_CELL = "toy.saturate"


def _toy_root(tmp_path, family=TOY_FAMILY, reference=TOY_REFERENCE):
    """``tiny_root`` with a second family added as files only: a dense
    two-layer MLP behind a queue (``families/toy.py``), its own inputs and
    plain reference (``families/toy_reference.py``), a metric of its own
    (``metrics/toy_rows_per_s.py``), a configuration and a cell. A few of
    the GCN family's per-layer metrics list the cell too; those that read
    the GCN family's fields have nothing to read."""
    root = helpers.tiny_root(tmp_path)
    bench_dir = root / "cardbench"
    (bench_dir / "families" / "toy.py").write_text(family)
    (bench_dir / "families" / "toy_reference.py").write_text(reference)
    (bench_dir / "metrics" / "toy_rows_per_s.py").write_text(TOY_METRIC)
    (bench_dir / "configs" / "toy.json").write_text(json.dumps({
        "name": "toy", "family": "toy", "rows": 8, "features": 12, "hidden": 16,
        "classes": 5, "tf32": False, "serving": {"max_batch": 2},
        "limits": {"out_rel_err": 1e-5}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="toy",
                                 file="cardbench/configs/toy.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name=TOY_CELL,
                                   config="toy"))
    for m in bench["per_layer"]:
        if m["name"] in ("batch_occupancy", "latency_p95_ms.saturate", "mfu",
                         "schedule_utilization", "spmm_range_roofline"):
            m["workloads"].append(TOY_CELL)
    bench["per_layer"].append({
        "name": "toy_rows_per_s", "unit": "rows/s", "better": "higher",
        "source": "host_clock", "layer": "toy queue", "moves": "requests_per_s",
        "workloads": [TOY_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("traced", [False, True])
def test_a_family_added_as_files_runs_and_is_correct(tmp_path, traced):
    r = _run(_toy_root(tmp_path), traced=traced, cell=TOY_CELL)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r["checks"]) == ["out_rel_err", "failed"]
    assert r["checks"]["out_rel_err"]["value"] <= 1e-5
    if traced:
        assert set(r["metrics"]) == {"batch_occupancy", "latency_p95_ms.saturate",
                                     "toy_rows_per_s"}
        assert r["metrics"]["batch_occupancy"]["value"] == 2.0
        assert r["metrics"]["toy_rows_per_s"]["value"] > 0
        assert "busy_s" in r["device"] and "breakdown" in r
    else:
        assert set(r["metrics"]) == {"requests_per_s", "latency_p95_ms", "setup_s"}


def test_a_fault_planted_in_a_familys_answers_makes_the_run_incorrect(tmp_path):
    faulty = TOY_FAMILY.replace("@ self.w1\n", "@ self.w1 * (1 + 1e-3)\n")
    assert faulty != TOY_FAMILY
    r = _run(_toy_root(tmp_path, family=faulty), cell=TOY_CELL)
    assert r["correct"] is False and r["failed"] == 0
    assert r["checks"]["out_rel_err"]["value"] > 1e-5


@pytest.mark.parametrize("found", ["{}", '{"out_rel_eror": err}',
                                   '{"out_rel_err": err, "extra": 0.0}'],
                         ids=["nothing", "another_name", "one_more"])
def test_a_check_that_does_not_return_the_configurations_limits_is_refused(
        tmp_path, found):
    old = 'return {"out_rel_err": err}'
    reference = TOY_REFERENCE.replace(old, f"return {found}")
    assert reference != TOY_REFERENCE
    with pytest.raises(ValueError, match=r"the configuration's limits are "
                                         r"\['out_rel_err'\]"):
        _run(_toy_root(tmp_path, reference=reference), cell=TOY_CELL)


def test_an_unknown_family_fails_before_any_input_is_made(tmp_path, monkeypatch):
    def made(*a, **kw):
        raise AssertionError("inputs made for a configuration of no family")

    monkeypatch.setattr(inputs, "cell", made)
    root = helpers.tiny_root(tmp_path, family="nosuch")
    with pytest.raises(KeyError, match=r"'nosuch'.*the families present: \['gcn'\]"):
        _run(root)


def test_a_family_module_without_the_whole_interface_is_refused(tmp_path, monkeypatch):
    """An adapter without its reference module is no family: the run fails
    before any input is made."""
    def made(*a, **kw):
        raise AssertionError("inputs made for a family without its reference")

    monkeypatch.setattr(inputs, "cell", made)
    root = helpers.tiny_root(tmp_path, family="half")
    (root / "cardbench" / "families" / "half.py").write_text(
        "def serve(cfg, mix, inp, device):\n    raise AssertionError\n")
    with pytest.raises(KeyError, match=r"no half.py and half_reference.py.*"
                                       r"the families present: \['gcn'\]"):
        _run(root)


EVEN_MIX = """
from cardbench import load

MIX = {"arrivals": "even", "rate_per_s": 300.0, "pool": 4, "deadline_s": 0.05,
       "warmup_rounds": 1}


class Even(load.OpenLoop):
    def gaps(self, seconds):
        n = round(self.rate_per_s * seconds)
        return [seconds / (n + 1)] * n


def loop(mix, engine, pool, seed, **kw):
    return Even(engine, pool, rate_per_s=mix.rate_per_s, seed=seed, **kw)
"""


def test_a_mix_with_a_generator_of_its_own_added_as_a_module_is_found(tmp_path):
    root = helpers.tiny_root(tmp_path)
    (root / "cardbench" / "traffic" / "even.py").write_text(EVEN_MIX)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(bench["workloads"][0], name="tiny.even",
                                   traffic="even"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = load.Mix.from_dict(spec.traffic("even", root))
    assert mix.arrivals == "even" and mix.pool == 4 and mix.make_loop is not None
    r = _run(root, cell="tiny.even")
    assert r["correct"] and r["failed"] == 0
    # 300/s over 0.3 s, evenly: the module's own 90 arrivals, not Poisson's
    assert r["attempted"] == 90
    assert r["metrics"]["latency_p95_ms"]["value"] > 0


def test_a_mix_of_neither_kind_without_a_generator_is_refused():
    with pytest.raises(ValueError, match="arrivals must be one of"):
        load.Mix.from_dict({"arrivals": "even", "rate_per_s": 3.0, "pool": 2,
                            "warmup_rounds": 1})


def test_an_open_loop_mix_runs_and_is_correct(tmp_path):
    root = helpers.tiny_root(tmp_path)
    (root / "cardbench" / "traffic" / "arrivals.json").write_text(json.dumps(
        {"arrivals": "poisson", "rate_per_s": 400.0, "pool": 6, "deadline_s": 0.05,
         "warmup_rounds": 1}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(bench["workloads"][0], name="tiny.arrivals",
                                   traffic="arrivals"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = _run(root, cell="tiny.arrivals")
    assert r["correct"] and r["failed"] == 0
    # 400/s over 0.3 s: every seed sends the same 120 arrivals
    assert r["attempted"] == 120
    assert r["metrics"]["latency_p95_ms"]["value"] > 0


def test_the_sweep_reports_each_rate_and_sends_every_arrival():
    cfg = helpers.tiny_config()
    lines = sweep.sweep(cfg, [200.0, 2e4], 0.3, 0.25, seed=3, device="cpu")
    assert [x["rate_per_s"] for x in lines] == [200.0, 2e4]
    for x in lines:
        assert x["failed"] == 0 and x["batch_occupancy"] > 0
    assert 0.4 * 200 < lines[0]["offered_per_s"] < 1.6 * 200
    # far past what the engine serves: arrivals pile up behind it, are sent
    # late after the window and answered, and the rate is not sustained
    over = lines[1]
    assert over["left_at_close"] > 8 and not over["sustained"]
    assert over["lateness_ms"] > 0


def test_nearest_rank_percentile():
    assert sweep.percentile([3, 1, 2, 4], 50) == 2
    assert sweep.percentile([3, 1, 2, 4], 95) == 4
    assert sweep.percentile(list(range(1, 101)), 95) == 95


def _patched(monkeypatch, fault):
    orig = ScheduleExecutor.forward_batch
    seen = []

    def forward_batch(self, params, xs):
        return fault(orig, self, params, xs, seen)

    monkeypatch.setattr(ScheduleExecutor, "forward_batch", forward_batch)


def _altered(orig, ex, params, xs, seen):
    return orig(ex, params, xs).mul_(1 + 1e-3)


def _half_left_out(orig, ex, params, xs, seen):
    half = orig(ex, params, xs[: max(1, xs.shape[0] // 2)])
    return torch.cat([half] * 2)[: xs.shape[0]]


def _stale(orig, ex, params, xs, seen):
    if not seen:
        seen.append(orig(ex, params, xs))
    return seen[0][: xs.shape[0]].clone()


@pytest.mark.parametrize("fault", [_altered, _half_left_out, _stale],
                         ids=["answer_altered", "half_batch_left_out", "stale_answer"])
def test_a_planted_fault_makes_the_run_incorrect(tmp_path, monkeypatch, fault):
    _patched(monkeypatch, fault)
    r = _run(helpers.tiny_root(tmp_path))
    assert r["correct"] is False
    err = r["checks"]["logits_rel_err"]
    assert err["value"] > err["limit"]


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, str(helpers.HERE / "run.py"), "--workload",
                        "gcn-reddit.saturate", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, timeout=120,
                       cwd=helpers.ROOT)
    assert p.returncode != 0
    assert p.stdout == ""
    assert "CUDA" in p.stderr


@pytest.mark.parametrize("rate, seconds", [(136.0, 10.0), (400.0, 0.3), (3.0, 10.0)])
def test_every_seed_gets_the_same_arrivals_in_another_order(rate, seconds):
    a = load.exponential_gaps(rate, seconds, seed=1)
    b = load.exponential_gaps(rate, seconds, seed=2**31 + 5)
    assert len(a) == round(rate * seconds) and sorted(a) == sorted(b)
    assert sum(a) < seconds
    # one cycle of gaps, started at another point
    assert any(b == a[k:] + a[:k] for k in range(len(a)))
    assert a != b or len(a) < 3
    # mean gap 1/rate; the quantiles keep the exponential's spread
    assert sum(a) / len(a) == pytest.approx(1 / rate, rel=0.05)
