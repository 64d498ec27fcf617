"""Run one cell of the benchmark once, in this process, on the card.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the cell's configuration names its model family: its reference
module, ``families/<family>_reference.py``, makes the inputs from
``--seed``, and its adapter, ``families/<family>.py``, sets the program up
with them; then a warm-up at the window's batch sizes), then ``--seconds``
of the cell's traffic through the program, then the family's check: a
sample of the window's answers, drawn from the seed, against its plain
reference, from the inputs and the answers alone. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``: each
number compared beside its limit, which also end standard error.

A run without a CUDA card, or with fewer cards than the cell asks for,
fails and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import torch  # noqa: E402

from cardbench import load, spec, trace  # noqa: E402
from cardbench.load import log, sync  # noqa: E402

#: top-level module names that may not be loaded in the process that
#: prints a result: JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: answers kept for the check, drawn from the seed among all the window's
SAMPLE = 16


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def run_cell(name: str, seed: int, seconds: float, traced: bool, *,
             root: Path = ROOT, device="cuda", t_start: float = T_START,
             config_over: dict | None = None) -> dict:
    """One run of cell ``name``; returns the result's fields.
    ``config_over`` replaces keys of the cell's configuration (the control
    runs the program with ``{"tf32": True}``)."""
    bench = spec.benchmark(root)
    cell = spec.workload(bench, name)
    cfg = {**spec.config(bench, cell["config"], root), **(config_over or {})}
    family = spec.family(cfg, root)
    mix = load.Mix.from_dict(spec.traffic(cell["traffic"], root))
    metrics = spec.cell_metrics(bench, name, traced)
    readers = {m["name"]: spec.reader(m["name"], root) for m in metrics}
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]

    rng = random.Random(seed)
    kept: dict = {}

    def keep(i, idx, out):
        slot = i if i < SAMPLE else rng.randrange(i + 1)
        if slot < SAMPLE:
            kept[slot] = (idx, out.clone())

    t = time.perf_counter()
    inp = family.reference.inputs(cfg, mix.pool_size(cfg["serving"]["max_batch"]),
                                  seed, dev)
    sync(dev)
    log(f"inputs with {len(inp.pool)} requests in {time.perf_counter() - t:.3f} s")
    s = family.adapter.serve(cfg, mix, inp, dev)
    try:
        t = time.perf_counter()
        load.warm_up(s.calls, inp.pool, mix.warmup_rounds)
        sync(dev)
        log(f"warm-up in {time.perf_counter() - t:.3f} s")
        # what set-up made lives as long as the server: freeze it, so that a
        # full collection in the window scans only what the window made (a
        # scan of the imports' objects stalls serving for about 0.1 s)
        gc.collect()
        gc.freeze()
        prof, span = None, load.nospan
        if traced:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
            span = record_function
        setup_s = time.perf_counter() - t_start
        loop = load.loop(mix, s.calls, inp.pool, seed, on_answer=keep, span=span)
        s.counting = True
        try:
            loop.run(seconds)
            sync(dev)
        finally:
            s.counting = False
            gc.unfreeze()
            if prof is not None:
                prof.__exit__(None, None, None)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        loop.drain()
        log(f"window {loop.seconds:.3f} s: {loop.completed_in_window} answered in it, "
            f"{loop.attempted} sent, {loop.failed} failed, {len(s.sizes)} batches, "
            f"generator late by {1e3 * getattr(loop, 'lateness_s', 0.0):.3f} ms "
            f"at most")
        fields = s.run_fields()
    finally:
        s.close()

    t = time.perf_counter()
    found = family.reference.check(inp, list(kept.values()))
    log(f"reference over {len(kept)} answers in {time.perf_counter() - t:.3f} s")
    if not found or set(found) != set(cfg["limits"]):
        raise ValueError(f"family {cfg['family']!r} checked {sorted(found)}; the "
                         f"configuration's limits are {sorted(cfg['limits'])}")
    checks = {k: {"value": v, "limit": cfg["limits"][k]} for k, v in found.items()}
    checks["failed"] = {"value": loop.failed, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    events = trace.from_profiler(prof) if prof is not None else None
    run = spec.Run(setup_s=setup_s, window_s=loop.seconds,
                   completed_in_window=loop.completed_in_window,
                   latencies_s=loop.latencies_s, batch_sizes=s.sizes, events=events,
                   fields=fields)
    values = {}
    for m in metrics:
        v = readers[m["name"]](run)
        if v is None and not traced:
            raise RuntimeError(f"end-to-end metric {m['name']!r} read nothing")
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": correct, "attempted": loop.attempted, "failed": loop.failed,
              "metrics": values, "device": device_info(dev, cell["chips"], peak)}
    if events is not None:
        result["device"]["busy_s"] = trace.busy_s(events)
        result["device"]["window_s"] = loop.seconds
        result["breakdown"] = trace.breakdown(events)
    result["checks"] = checks
    return result


def device_info(dev: torch.device, chips: int, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": dev.type, "kind": dev.type, "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
            "memory_peak_bytes": peak, "power_limit": power_limit()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    chips = spec.workload(spec.benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"cell {args.workload!r} needs {chips} CUDA card(s); "
            f"this machine has {have}")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"the run loaded {found}: the benchmark measures the port alone")
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
