"""End-to-end driver on PyTorch/CUDA (the counterpart of ``serve_gcn.py``):
serve batched GCN inference over multiple resident graphs with the AWB
engine of ``repro_torch``.

    PYTHONPATH=src python examples/serve_gcn_torch.py [--device cpu]

Trains small 2-layer GCNs on two synthetic graphs through
``gcn.loss_fn`` with ``spmm_cuda.make_spmm_fn`` as its SpMM (the kernels
forward, and on Aᵀ's schedule backward), admits them into a
``GCNServingEngine`` backed by an on-disk tuning store — the first
admission runs the measured autotune sweep (pruned by the paper's cycle
model) and persists the converged configuration + schedule — then
**simulates a process restart**: a fresh engine on the same store
warm-starts every graph with zero measured sweeps and zero schedule
rebuilds. It then serves batched feature-perturbation requests and reports
throughput, first with manual ``flush()``, then deadline-driven
(``submit(..., deadline_s=)`` and a ``poll()`` loop that flushes
earliest-deadline-first), and finally replicates a hot graph onto a second
position of the device (``devices=[dev] * 2``: one card runs both
positions, so this shows the mechanism, not scaling).

It runs on the card by default and raises without one; ``--device cpu``
runs the kernels' plain versions on the host.
"""
import argparse
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import gcn, schedule
from repro_torch.device import resolve_device
from repro_torch.graphs import synth
from repro_torch.kernels import spmm_cuda
from repro_torch.serving.gcn_engine import GCNServingEngine
from repro_torch.tuning import registry


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_workload(name: str, scale: int, seed: int, dev: torch.device):
    ds = synth.make_dataset(name, scale=scale, device=dev)
    cfg = gcn.GCNConfig(ds.num_features, ds.hidden, ds.num_classes)
    params = gcn.init_params(cfg, torch.Generator().manual_seed(seed), dev)
    x = torch.from_numpy(ds.features).to(dev)
    labels = torch.from_numpy(ds.labels).to(dev)
    spmm_fn = spmm_cuda.make_spmm_fn(ds.adj)  # kernels forward, Aᵀ backward
    for _ in range(60):
        live = {k: v.requires_grad_(True) for k, v in params.items()}
        loss = gcn.loss_fn(live, ds.adj, x, labels, spmm_fn=spmm_fn)
        grads = torch.autograd.grad(loss, list(live.values()))
        params = {k: (p - 0.5 * g).detach() for (k, p), g in zip(live.items(), grads)}
    acc = float(gcn.accuracy(params, ds.adj, x, labels))
    print(f"  {name}: trained (loss {float(loss.detach()):.3f}, fit-acc {acc:.2%}, "
          f"chance {1 / ds.num_classes:.2%})")
    return ds, params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device; 'cpu' runs on the host")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    store_root = tempfile.mkdtemp(prefix="awb-serve-store-")
    try:
        print("training inference weights:")
        loads = {name: train_workload(name, scale, i, dev)
                 for i, (name, scale) in enumerate(
                     [("pubmed", 4), ("cora", 1)])}

        # ---- cold start: converge once, persist ------------------------
        print("\ncold start (measured sweep -> store):")
        engine = GCNServingEngine(store_root=store_root, device=dev)
        for name, (ds, params) in loads.items():
            rep = engine.add_graph(name, ds.adj, params)
            cfg = rep.config
            naive = schedule.build_naive_schedule(
                ds.adj, cfg.nnz_per_step, cfg.rows_per_window)
            print(f"  {name}: tuned in {rep.tune_seconds:.2f}s -> "
                  f"K={cfg.nnz_per_step} R={cfg.rows_per_window} "
                  f"ktile={cfg.ktile} routing={cfg.routing} "
                  f"({cfg.measured_us:.0f}us/spmm, bf16 max-err "
                  f"{cfg.bf16_max_err:.1e}); AWB util "
                  f"{cfg.utilization:.1%} vs static {naive.utilization:.1%}")

        # ---- restart: warm start from the store ------------------------
        print("\nsimulated restart (fresh engine, same store):")
        registry.clear_caches()  # drop every in-process cache
        engine = GCNServingEngine(store_root=store_root, devices=[dev] * 2,
                                  max_replicas=2, replicate_after_s=0.05,
                                  replica_shrink_after=2)
        for name, (ds, params) in loads.items():
            t0 = time.time()
            rep = engine.add_graph(name, ds.adj, params)
            assert rep.warm_start, "store should have been hit"
            print(f"  {name}: warm-started in {time.time() - t0:.3f}s "
                  f"(zero sweeps, zero rebuilds, "
                  f"{rep.device_bytes / 1024:.0f} KiB resident)")

        # ---- serve batched requests over both graphs -------------------
        n_batches, batch = 5, 8
        rng = np.random.default_rng(1)
        t0 = time.time()
        for _ in range(n_batches):
            for name, (ds, params) in loads.items():
                x = np.asarray(ds.features, np.float32)
                for _ in range(batch):
                    mask = (rng.random(x.shape) < 0.9).astype(np.float32)
                    engine.submit(name, x * mask)
            engine.flush()
            _sync(dev)
        dt = time.time() - t0
        n_req = n_batches * batch * len(loads)
        print(f"\nserved {n_req} requests over {len(loads)} graphs in "
              f"{dt:.2f}s ({n_req / dt:.1f} req/s, one batched forward per "
              f"graph-batch)")

        # ---- deadline-aware serving: SLAs instead of manual flush ------
        engine.reset_stats()
        sla_s = 1.0
        for _ in range(n_batches):
            for name, (ds, params) in loads.items():
                x = np.asarray(ds.features, np.float32)
                for _ in range(batch):
                    mask = (rng.random(x.shape) < 0.9).astype(np.float32)
                    engine.submit(name, x * mask, deadline_s=sla_s)
            # the poll loop is the serving thread: queues auto-flush
            # earliest-deadline-first as their SLAs come due
            while engine.stats()["pending_requests"]:
                engine.poll()
                time.sleep(0.01)
        st = engine.stats()
        judged = st["deadline_met"] + st["deadline_misses"]
        print(f"deadline serving ({sla_s * 1e3:.0f}ms SLA): "
              f"{st['deadline_met']}/{judged} met, latency mean "
              f"{st['latency_us_mean'] / 1e3:.0f}ms "
              f"max {st['latency_us_max'] / 1e3:.0f}ms")

        # ---- one hot graph saturates its device: replicate it ----------
        # hammer a single graph until its backlog (per-request service
        # EWMA x queue depth) trips the replication policy; the clone is
        # warm (same store entry: one upload, zero sweeps) and batches
        # split across replicas behind a least-outstanding-work balancer
        hot = "pubmed"
        ds, params = loads[hot]
        x = np.asarray(ds.features, np.float32)
        for _ in range(3 * batch):
            mask = (rng.random(x.shape) < 0.9).astype(np.float32)
            engine.submit(hot, x * mask, deadline_s=0.0)
        engine.poll()  # due now; the backlog grows a replica first
        st = engine.stats()
        print(f"\nhot-graph replication: {hot!r} now on devices "
              f"{st['replicas'].get(hot, '— (already drained)')} "
              f"(+{st['replicas_added']} replica)")
        for _ in range(3):
            engine.poll()  # idle polls: pressure gone, replicas shed
        st = engine.stats()
        print(f"after idle polls: replicas={st['replicas']} "
              f"(dropped {st['replicas_dropped']})")

        # engine output matches the reference forward
        for name, (ds, params) in loads.items():
            x = torch.from_numpy(ds.features).to(dev)
            ref = gcn.forward(params, ds.adj, x)
            got = engine.infer(name, x)
            err = float((ref - got.to(dev)).abs().max())
            print(f"  {name}: engine-vs-ref err {err:.1e}")
            assert err < 1e-3
        print("stats:", engine.stats())
        print("OK")
    finally:
        shutil.rmtree(store_root, ignore_errors=True)


if __name__ == "__main__":
    main()
