"""The port's four examples on the CPU (``--device cpu``): each finishes with
``OK``, and the host-side numbers it prints (graph stats, autotuner trails,
schedule steps and utilization, placement imbalances) equal the same
quantities computed here by the JAX package's own functions. Without a
card and without ``--device cpu`` each raises: none falls back."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart_torch", "serve_gcn_torch", "train_lm_torch",
            "moe_rebalance_torch")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(out: str) -> list:
    return [line.rstrip() for line in out.splitlines()]


def _in_order(want: list, got: list) -> None:
    at = 0
    for line in want:
        assert line in got[at:], (line, got)
        at = got.index(line, at) + 1


def test_quickstart_prints_the_references_numbers(capsys):
    from repro.core import autotuner, profiler, schedule
    from repro.graphs import synth

    _load("quickstart_torch").main(["--device", "cpu"])
    got = _lines(capsys.readouterr().out)
    assert got[-1] == "OK"

    ds = synth.make_dataset("cora", scale=2)
    prof = profiler.profile_matrix(ds.adj, "cora/2")
    want = [f"graph: {prof.shape[0]} nodes, {prof.nnz} nnz, "
            f"density {prof.density:.2%}",
            f"row nnz: mean {prof.row_nnz_mean:.1f}, p99 {prof.row_nnz_p99:.0f},"
            f" max {prof.row_nnz_max} | gini {prof.gini:.2f} | "
            f"{prof.evil_rows} evil rows hold {prof.evil_share:.0%} of work",
            "autotuning utilization per round (1024 PEs):"]
    row_nnz = np.asarray(np.bincount(np.asarray(ds.adj.row), minlength=ds.num_nodes),
                         np.float64)
    for name, cfg in autotuner.designs_for("cora").items():
        util, log = autotuner.converged_utilization(row_nnz, 1024, cfg)
        trail = " ".join(f"{r.utilization:.2f}" for r in log[:6])
        want.append(f"  design {name:8s}: {trail} -> {util:.2f}")
    naive = schedule.build_naive_schedule(ds.adj, 128, 64)
    awb = schedule.build_balanced_schedule(ds.adj, 128, 64)
    want.append(f"schedule steps: naive {naive.n_steps} (util "
                f"{naive.utilization:.1%}) vs AWB {awb.n_steps} "
                f"(util {awb.utilization:.1%}) -> "
                f"{naive.n_steps / awb.n_steps:.2f}x fewer issued slots")
    _in_order(want, got)
    assert any(line.startswith("AWB SpMM kernels on cpu: max err vs oracle")
               for line in got)
    assert any(line.startswith("executor (") for line in got)
    assert any(line.startswith("tuning store: converged in") for line in got)


def test_serve_gcn_prints_the_references_numbers(capsys, monkeypatch):
    from repro.core import schedule
    from repro.graphs import synth
    from repro.tuning import registry as jregistry

    ex = _load("serve_gcn_torch")
    reports = []
    add_graph = ex.GCNServingEngine.add_graph

    def recording_add_graph(self, graph_id, a, params, **kw):
        rep = add_graph(self, graph_id, a, params, **kw)
        reports.append(rep)
        return rep

    monkeypatch.setattr(ex.GCNServingEngine, "add_graph", recording_add_graph)
    ex.main(["--device", "cpu"])
    got = _lines(capsys.readouterr().out)
    assert got[-1] == "OK"
    cold = [r for r in reports if not r.warm_start]
    assert [r.graph_id for r in cold] == ["pubmed", "cora"]
    assert [r.graph_id for r in reports if r.warm_start] == ["pubmed", "cora"]
    want = []
    for rep, (name, scale) in zip(cold, [("pubmed", 4), ("cora", 1)]):
        ds = synth.make_dataset(name, scale=scale)
        cfg = rep.config
        awb = jregistry.get_schedule(ds.adj, **cfg.as_schedule_kwargs())
        naive = schedule.build_naive_schedule(ds.adj, cfg.nnz_per_step,
                                              cfg.rows_per_window)
        assert cfg.utilization == awb.utilization
        want.append(f"  {name}: tuned in {rep.tune_seconds:.2f}s -> "
                    f"K={cfg.nnz_per_step} R={cfg.rows_per_window} "
                    f"ktile={cfg.ktile} routing={cfg.routing} "
                    f"({cfg.measured_us:.0f}us/spmm, bf16 max-err "
                    f"{cfg.bf16_max_err:.1e}); AWB util "
                    f"{awb.utilization:.1%} vs static {naive.utilization:.1%}")
        chance = f"chance {1 / ds.num_classes:.2%})"
        assert any(line.startswith(f"  {name}: trained") and line.endswith(chance)
                   for line in got), chance
    _in_order(want, got)
    assert "served 80 requests over 2 graphs in" in " ".join(got)
    for name in ("pubmed", "cora"):
        err = [line for line in got if line.startswith(f"  {name}: engine-vs-ref err")]
        assert len(err) == 1 and float(err[0].split()[-1]) < 1e-3


def test_train_lm_loss_drops(capsys):
    losses = _load("train_lm_torch").main(["--device", "cpu"])
    got = _lines(capsys.readouterr().out)
    assert got[-1] == "OK"
    assert len(losses) == 60 and losses[0] - losses[-1] > 0.1
    assert f"loss {losses[0]:.3f} -> {losses[-1]:.3f} (drop " \
           f"{losses[0] - losses[-1]:.3f})" in got
    assert all(np.isfinite(losses))


def test_moe_rebalance_prints_the_references_numbers(capsys):
    from repro.core import moe_balance

    _load("moe_rebalance_torch").main(["--device", "cpu"])
    got = _lines(capsys.readouterr().out)
    assert got[-1] == "OK"
    e, devices = 128, 16
    load = moe_balance.zipf_expert_load(e, 200_000, alpha=1.0, seed=0)
    static = moe_balance.static_placement(e, devices)
    want = [f"router load: top expert holds {load.max() / load.sum():.1%} of "
            f"tokens (power law, {e} experts)",
            f"static placement imbalance (max/mean device load): "
            f"{moe_balance.imbalance(moe_balance.device_loads(static, load)):.2f}x"]
    for spare in (0, 16, 32):
        bal = moe_balance.balance_placement(load, devices,
                                            slots_per_device=(e + spare) // devices)
        imb = moe_balance.imbalance(moe_balance.device_loads(bal, load))
        want.append(f"AWB placement, {spare:2d} spare slots: imbalance {imb:.3f}x "
                    f"(max replicas {int(bal.replica_count.max())})")
    assert got[:len(want)] == want
    err = [line for line in got if line.startswith("MoE layer output")]
    assert len(err) == 1 and "max err 0.00e+00" in err[0]


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_raise_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _load(name).main([])
