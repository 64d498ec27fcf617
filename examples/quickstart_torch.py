"""Quickstart on PyTorch/CUDA: AWB-GCN's workload rebalancing on a power-law
graph, through ``repro_torch`` (the counterpart of ``quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Builds a synthetic Cora-statistics graph, profiles its power-law imbalance,
converges the per-round autotuner (paper §IV / Fig. 17), builds the static
baseline vs AWB-balanced schedules, runs the hand-written SpMM kernels
(``spmm_cuda.spmm_balanced``: window and epilogue) against the COO
reference, and serves repeated products through the cached device-resident
``ScheduleExecutor`` (the paper's "converge, then reuse the ideal
configuration"), then warm-restarts it from the on-disk tuning store.

It runs on the card by default and raises without one; ``--device cpu``
runs the kernels' plain versions on the host.
"""
import argparse
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import autotuner, executor, profiler, schedule, spmm
from repro_torch.device import resolve_device
from repro_torch.graphs import synth
from repro_torch.kernels import spmm_cuda
from repro_torch.tuning import TuningStore, clear_caches, warm_tuned_executor


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device; 'cpu' runs on the host")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = synth.make_dataset("cora", scale=2, device=dev)
    prof = profiler.profile_matrix(ds.adj, "cora/2")
    print(f"graph: {prof.shape[0]} nodes, {prof.nnz} nnz, "
          f"density {prof.density:.2%}")
    print(f"row nnz: mean {prof.row_nnz_mean:.1f}, p99 {prof.row_nnz_p99:.0f},"
          f" max {prof.row_nnz_max} | gini {prof.gini:.2f} | "
          f"{prof.evil_rows} evil rows hold {prof.evil_share:.0%} of work")

    # --- the paper's iterative autotuner (Fig. 17) -----------------------
    row_nnz = np.asarray(
        np.bincount(np.asarray(ds.adj.row), minlength=ds.num_nodes),
        np.float64)
    print("\nautotuning utilization per round (1024 PEs):")
    for name, cfg in autotuner.designs_for("cora").items():
        util, log = autotuner.converged_utilization(row_nnz, 1024, cfg)
        trail = " ".join(f"{r.utilization:.2f}" for r in log[:6])
        print(f"  design {name:8s}: {trail} -> {util:.2f}")

    # --- static schedules: baseline vs AWB -------------------------------
    naive = schedule.build_naive_schedule(ds.adj, 128, 64)
    awb = schedule.build_balanced_schedule(ds.adj, 128, 64)
    print(f"\nschedule steps: naive {naive.n_steps} (util "
          f"{naive.utilization:.1%}) vs AWB {awb.n_steps} "
          f"(util {awb.utilization:.1%}) -> "
          f"{naive.n_steps / awb.n_steps:.2f}x fewer issued slots")

    # --- the SpMM kernels (the plain versions on the CPU) ----------------
    rng = np.random.default_rng(0)
    b = torch.from_numpy(
        rng.standard_normal((ds.num_nodes, 16)).astype(np.float32)).to(dev)
    gold = spmm.spmm_coo(ds.adj, b)
    t0 = time.time()
    out = spmm_cuda.spmm_balanced(awb, b, ktile=16)
    _sync(dev)
    err = float((out - gold).abs().max())
    print(f"\nAWB SpMM kernels on {dev}: max err vs oracle {err:.2e} "
          f"({time.time() - t0:.1f}s, first call: plan + upload"
          f"{' + build' if dev.type == 'cuda' else ''})")
    assert err < 1e-4

    # --- the converge-then-reuse loop: cached device-resident executor ---
    ex = executor.get_executor(ds.adj, device=dev)
    out = ex.spmm(b)  # first call: converge + upload
    _sync(dev)
    t0 = time.time()
    n_reps = 20
    for _ in range(n_reps):
        out_dev = ex.spmm(b)  # cache hit: zero schedule transfers
    _sync(dev)
    err = float((out_dev - gold).abs().max())
    assert executor.get_executor(ds.adj, device=dev) is ex  # fingerprint cache hit
    print(f"executor ({ex.routing} routing): "
          f"{(time.time() - t0) / n_reps * 1e3:.2f} ms/call reused, "
          f"max err vs oracle {err:.2e}")
    assert err < 1e-4

    # --- make the convergence durable: the on-disk tuning store ----------
    # (examples/serve_gcn_torch.py drives the full multi-graph serving engine)
    root = tempfile.mkdtemp(prefix="awb-quickstart-store-")
    try:
        store = TuningStore(root)
        t0 = time.time()
        _, cfg = warm_tuned_executor(ds.adj, (ds.num_nodes, 16), store=store,
                                     device=dev)
        cold_s = time.time() - t0
        clear_caches()  # ≈ process restart; the store survives
        t0 = time.time()
        ex2, cfg2 = warm_tuned_executor(ds.adj, (ds.num_nodes, 16), store=store,
                                        device=dev)
        warm_s = time.time() - t0
        assert cfg2 == cfg  # same converged configuration, no re-sweep
        err = float((ex2.spmm(b) - gold).abs().max())
        print(f"tuning store: converged in {cold_s:.2f}s, warm restart in "
              f"{warm_s * 1e3:.0f}ms (bf16 max-err {cfg.bf16_max_err:.1e}), "
              f"max err vs oracle {err:.2e}")
        assert err < 1e-4
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("OK")


if __name__ == "__main__":
    main()
