#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

1. Builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` and holds them against the plain COO product and their
   plain PyTorch versions at the kernel tests' small shapes (balanced,
   naive, blocked with evil rows, row-reordered).
2. Serves 3 batches of 4 requests on the full-width ``reddit`` graph
   (232,965 nodes, 602 features, hidden 128, 41 classes) through the port's
   main path — ``registry.get_executor`` → ``ScheduleExecutor.forward_batch``
   — with the launch counts reset just before and read just after, and
   holds every request's logits against the plain COO forward.
3. Holds each kernel against its plain version at the main path's shapes
   and times kernel, plain version and ``torch.sparse.mm`` on the CSR
   adjacency (a yardstick the port never calls) with CUDA events.

Float32 matmuls and cuDNN run without TF32 (both flags are set False), so
every float32 product is full float32. Tolerances: 1e-4·max(1, |gold|max)
for float32, 3e-2·max(1, |gold|max) for bfloat16 — the JAX package's kernel
test tolerances.

Prints a ``{"kernels": [...]}`` line, a ``{"serving": ...}`` line, the
window kernel's all-gathers-miss bound per kdim, the card's name and power
limit, and as its last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device, or without the rest of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet: HBM3 rate and non-tensor-core float32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
REPLACES = {
    "spmm_balanced": "src/repro/kernels/spmm_pallas.py:54",
    "spmm_epilogue": "src/repro/core/schedule.py:898",
}
BATCHES, BATCH_SIZE, KEEP = 3, 4, 0.9


def tol(gold, dtype) -> float:
    import torch

    scale = max(1.0, float(gold.abs().max()))
    return (1e-4 if dtype == torch.float32 else 3e-2) * scale


def check(name, got, gold, dtype) -> float:
    err = float((got.float() - gold.float()).abs().max()) if gold.numel() else 0.0
    if not err <= tol(gold, dtype):
        raise AssertionError(f"{name}: max |err| {err} > {tol(gold, dtype)}")
    return err


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout
    return out.strip().splitlines()[0]


def timed_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_small(dev) -> int:
    """Kernel vs the plain COO product and vs its plain version at the JAX
    package's kernel-test shapes. Returns the number of cases checked."""
    import numpy as np
    import torch

    from repro_torch.core import schedule, spmm
    from repro_torch.graphs import synth
    from repro_torch.kernels import spmm_cuda
    from repro_torch.tuning import registry

    def operand(n, k, seed):
        rng = np.random.default_rng(seed)
        return torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(dev)

    cases = 0
    for n, density, alpha in [(64, 0.05, 0.8), (200, 0.02, 1.1), (123, 0.08, 0.6)]:
        a = synth.power_law_adjacency(n, density, alpha, seed=n)
        s = schedule.build_balanced_schedule(a, 32, 16)
        for kdim in (5, 16, 24):
            b = operand(n, kdim, n)
            gold = spmm.spmm_coo(a, b)
            for dtype in (torch.float32, torch.bfloat16):
                got = spmm_cuda.spmm_balanced(s, b.to(dtype), ktile=8)
                plain = spmm_cuda.spmm_balanced_plain(s, b.to(dtype))
                check(f"balanced n={n} k={kdim} {dtype}", got, gold, dtype)
                check(f"plain n={n} k={kdim} {dtype}", got, plain, dtype)
                cases += 1
    a = synth.power_law_adjacency(150, 0.04, 1.0, seed=9)
    b = operand(150, 12, 9)
    for builder in (schedule.build_balanced_schedule, schedule.build_naive_schedule):
        got = spmm_cuda.spmm_balanced(builder(a, 16, 8), b, ktile=8)
        check(f"{builder.__name__}", got, spmm.spmm_coo(a, b), torch.float32)
        cases += 1
    a = synth.power_law_adjacency(96, 0.1, 1.2, seed=4)
    b = operand(96, 9, 4)
    s = schedule.build_balanced_schedule(a, 16, 8, cols_per_block=32, evil_threshold=8)
    if s.n_evil_chunks == 0:
        raise AssertionError("blocked case has no evil chunks")
    check("blocked+evil", spmm_cuda.spmm_balanced(s, b, ktile=8),
          spmm.spmm_coo(a, b), torch.float32)
    a = synth.power_law_adjacency(300, 0.03, 0.9, seed=7)
    b = operand(300, 12, 7)
    for routing in ("gather", "onehot"):
        ex = registry.get_executor(a, nnz_per_step=32, rows_per_window=16,
                                   reorder="degree", routing=routing, device=dev)
        check(f"reordered executor ({routing})", ex.spmm(b), spmm.spmm_coo(a, b),
              torch.float32)
        cases += 1
    torch.cuda.synchronize()
    return cases + 1


def glorot(dims, seed: int) -> dict:
    """Glorot-uniform weights from a numpy seed, as ``gcn.init_params``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    params = {}
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        lim = np.sqrt(6.0 / (din + dout))
        params[f"w{i}"] = rng.uniform(-lim, lim, (din, dout)).astype(np.float32)
    return params


def phase_serve(dev):
    """The main path at full width; returns what phase 3 needs."""
    import torch

    from repro_torch.core import gcn
    from repro_torch.graphs import synth
    from repro_torch.kernels import spmm_cuda
    from repro_torch.tuning import registry

    t0 = time.perf_counter()
    ds = synth.make_dataset("reddit", scale=1, device=dev)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex = registry.get_executor(ds.adj, device=dev)
    torch.cuda.synchronize()
    t_exec = time.perf_counter() - t0
    sched = ex.sched
    cfg = gcn.GCNConfig(ds.num_features, ds.hidden, ds.num_classes)
    params = gcn.params_from_jax(glorot(cfg.dims, seed=0), dev)
    x = torch.from_numpy(ds.features).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [
        torch.stack([
            x * (torch.rand(x.shape, generator=gen, device=dev) < KEEP)
            for _ in range(BATCH_SIZE)
        ])
        for _ in range(BATCHES)
    ]
    torch.cuda.synchronize()

    spmm_cuda.reset_launches()
    outs, batch_ms = [], []
    t_all = time.perf_counter()
    for xb in batches:
        t0 = time.perf_counter()
        outs.append(ex.forward_batch(params, xb))
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    serve_s = time.perf_counter() - t_all
    launches = dict(spmm_cuda.LAUNCHES)
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"main path never launched {name}")

    adj = ds.adj._replace(row=ds.adj.row.to(dev), col=ds.adj.col.to(dev),
                          val=ds.adj.val.to(dev))
    max_err = 0.0
    for xb, out in zip(batches, outs):
        if out.shape != (BATCH_SIZE, ds.num_nodes, ds.num_classes):
            raise AssertionError(f"logits have shape {tuple(out.shape)}")
        if not torch.isfinite(out).all():
            raise AssertionError("non-finite logits")
        for i in range(BATCH_SIZE):
            gold = gcn.forward(params, adj, xb[i])
            max_err = max(max_err, check("request logits", out[i], gold,
                                         torch.float32))
    # the dense X·W products of one batch (both layers, ReLU between), timed
    # apart so the batch time splits into dense products and SpMM kernels
    xb = batches[0]
    xw_ms = timed_ms(lambda: torch.relu(xb @ params["w0"]) @ params["w1"], 5)
    n_req = BATCHES * BATCH_SIZE
    serving = {
        "graph": "reddit", "nodes": ds.num_nodes, "features": ds.num_features,
        "hidden": ds.hidden, "classes": ds.num_classes, "nnz": int(ds.adj.nnz),
        "n_steps": sched.n_steps, "n_windows": sched.n_windows,
        "utilization": sched.utilization, "n_evil_chunks": sched.n_evil_chunks,
        "requests": n_req, "batches": BATCHES, "batch_size": BATCH_SIZE,
        "requests_per_s": n_req / serve_s,
        "steady_requests_per_s": (BATCHES - 1) * BATCH_SIZE / (
            sum(batch_ms[1:]) / 1e3),
        "batch_ms": batch_ms, "xw_ms_per_batch": xw_ms, "max_abs_err": max_err,
        "dataset_s": t_data, "executor_build_s": t_exec,
    }
    del batches, outs
    return ds, ex, launches, serving


def bytes_window(steps, n, kdim, elt, n_live, all_miss=False) -> int:
    n_steps, k = steps.val.shape
    meta = n_steps * k * 12 + n_steps * 4 + steps.win_ptr.numel() * 4
    meta += steps.row_map.numel() * 4
    b_bytes = (n_steps * k if all_miss else n) * kdim * elt
    return meta + b_bytes + n_live * kdim * 4


def phase_kernels(ds, ex, launches):
    """Each kernel vs its plain version and the library call at the main
    path's shapes (batched: 4 requests × 128 and × 41 columns) and at one
    request's (128 and 41); times in ms per call."""
    import numpy as np
    import torch

    from repro_torch.kernels import spmm_cuda

    dev = ex.device
    steps = ex._steps
    m, n = ds.adj.shape
    live = steps.row_map >= 0
    n_live = int(live.sum())
    # multiplies this run's data needs: padding slots (val 0) are skipped
    n_nnz = int((steps.val != 0).sum())
    csr = ds.adj_csr
    a_csr = torch.sparse_csr_tensor(
        csr.indptr.long(), csr.indices.long(), csr.data, size=(m, n)
    ).to(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = {"spmm_balanced": [], "spmm_epilogue": []}
    all_miss = {}
    main_widths = (BATCH_SIZE * ds.hidden, BATCH_SIZE * ds.num_classes)
    for kdim in main_widths + (ds.hidden, ds.num_classes):
        b = torch.randn((n, kdim), generator=gen, device=dev)
        out_k = spmm_cuda.spmm_window(steps, b, ktile=ex.ktile)
        out_p = spmm_cuda.spmm_window_plain(steps, b)
        err_w = check(f"spmm_window k={kdim}", out_k[live], out_p[live],
                      torch.float32)
        epi_k = spmm_cuda.spmm_epilogue(steps, out_p, torch.float32)
        epi_p = spmm_cuda.spmm_epilogue_plain(steps, out_p, torch.float32)
        err_e = check(f"spmm_epilogue k={kdim}", epi_k, epi_p, torch.float32)
        lib = torch.sparse.mm(a_csr, b)
        check(f"sparse.mm vs kernels k={kdim}", epi_k, lib, torch.float32)
        del out_k, epi_k, lib
        w_ms = timed_ms(lambda: spmm_cuda.spmm_window(steps, b, ktile=ex.ktile), 10)
        wp_ms = timed_ms(lambda: spmm_cuda.spmm_window_plain(steps, b), 2)
        e_ms = timed_ms(lambda: spmm_cuda.spmm_epilogue(steps, out_p, torch.float32),
                        10)
        ep_ms = timed_ms(
            lambda: spmm_cuda.spmm_epilogue_plain(steps, out_p, torch.float32), 3)
        tgt = steps.row_map.long()[live]
        src = out_p[live]
        e_lib = timed_ms(
            lambda: torch.zeros((m, kdim), device=dev).index_add_(0, tgt, src), 10)
        lib_ms = timed_ms(lambda: torch.sparse.mm(a_csr, b), 10)
        del out_p, src
        w_bytes = bytes_window(steps, n, kdim, 4, n_live)
        w_miss = bytes_window(steps, n, kdim, 4, n_live, all_miss=True)
        w_ops_ms = 2 * n_nnz * kdim / PEAK_F32_FLOPS * 1e3
        all_miss[str(kdim)] = w_miss / PEAK_BYTES_PER_S * 1e3
        e_bytes = n_live * kdim * 4 + (m + 1 + n_live) * 4 + m * kdim * 4
        rows["spmm_balanced"].append({
            "kdim": kdim, "main_path": kdim in main_widths, "max_abs_err": err_w,
            "ms": w_ms, "plain_ms": wp_ms, "library_ms": lib_ms,
            "bound_ms": max(w_bytes / PEAK_BYTES_PER_S * 1e3, w_ops_ms),
            "bound_by": "bytes" if w_bytes / PEAK_BYTES_PER_S * 1e3 >= w_ops_ms
            else "operations",
        })
        rows["spmm_epilogue"].append({
            "kdim": kdim, "main_path": kdim in main_widths, "max_abs_err": err_e,
            "ms": e_ms, "plain_ms": ep_ms, "library_ms": e_lib,
            "bound_ms": e_bytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
        })
    kernels = []
    for name, shapes in rows.items():
        main = [s for s in shapes if s["main_path"]]
        # per forward_batch call: one launch of each kernel per layer
        entry = {
            "name": name, "route": "cuda", "source": spmm_cuda.SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "bound_by": "bytes" if all(s["bound_by"] == "bytes" for s in main)
            else "operations",
            "per": "one forward_batch of 4 requests (both layers)",
        }
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            entry[key] = float(np.sum([s[key] for s in main]))
        entry["shapes"] = shapes
        kernels.append(entry)
    return kernels, all_miss


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()

    t0 = time.perf_counter()
    _build.build(["spmm_balanced"])
    build_s = time.perf_counter() - t0
    for name, log in _build.BUILD_LOGS.items():
        print(f"[build] {name}.cu in {build_s:.1f} s\n{log.strip()}", file=sys.stderr)

    t0 = time.perf_counter()
    n_cases = phase_small(dev)
    print(f"[phase 1] {n_cases} small kernel checks passed in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    ds, ex, launches, serving = phase_serve(dev)
    print(f"[phase 2] served {serving['requests']} requests", file=sys.stderr)
    kernels, all_miss = phase_kernels(ds, ex, launches)
    serving["build_s"] = build_s
    serving["card"] = card

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"serving": serving}))
    # the window kernel's bound if every gathered B row came from HBM, per kdim
    print(json.dumps({"spmm_balanced_bound_all_miss_ms": all_miss}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
