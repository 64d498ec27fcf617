"""Find the highest Poisson arrival rate a configuration's engine sustains:
the knee that an open-loop cell's fixed rate is set from.

    python3 cardbench/sweep.py --config <config> --rates 120 160 180 200 --seconds 10

One set-up (the configuration's family serves: its inputs from ``--seed``
and the program set up with them; a warm-up), then each rate in turn for
``--seconds``: Poisson arrivals, each request with ``--deadline`` seconds,
its latency from the moment it was due. A rate is sustained when the p95
meets the deadline and the backlog does not grow: no more than two
batches' requests (``serving.max_batch`` of the configuration) are left
unanswered at the window's end. One JSON line per rate, then the knee.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                    str(Path(__file__).resolve().parents[1])]

import torch  # noqa: E402

from cardbench import load, spec  # noqa: E402


def percentile(values, q: float) -> float:
    """Nearest rank: the smallest value that ``q`` % of ``values`` meet."""
    v = sorted(values)
    return v[max(0, math.ceil(len(v) * q / 100) - 1)] if v else float("nan")


def sweep(cfg: dict, rates, seconds: float, deadline_s: float, seed: int, device,
          pool: int = 8, warmup_rounds: int = 2) -> list:
    mix = load.Mix(arrivals=load.POISSON, deadline_s=deadline_s,
                   warmup_rounds=warmup_rounds, rate_per_s=max(rates), pool=pool)
    family, dev = spec.family(cfg), torch.device(device)
    inp = family.reference.inputs(cfg, mix.pool_size(cfg["serving"]["max_batch"]),
                                  seed, dev)
    s = family.adapter.serve(cfg, mix, inp, dev)
    lines = []
    try:
        load.warm_up(s.calls, inp.pool, warmup_rounds)
        for i, rate in enumerate(rates):
            s.sizes = []
            s.counting = True
            loop = load.OpenLoop(s.calls, inp.pool, rate_per_s=rate, seed=seed + i)
            loop.run(seconds)
            s.counting = False
            loop.drain()
            left = len(loop.latencies_s) - loop.completed_in_window
            lat = loop.latencies_s
            p95 = percentile(lat, 95)
            lines.append({
                "rate_per_s": rate, "seconds": loop.seconds,
                "offered_per_s": loop.attempted / loop.seconds,
                "answered_per_s": loop.completed_in_window / loop.seconds,
                "p50_ms": 1e3 * percentile(lat, 50), "p95_ms": 1e3 * p95,
                "missed_deadline": sum(x > deadline_s for x in lat),
                "left_at_close": left, "failed": loop.failed,
                "lateness_ms": 1e3 * loop.lateness_s,
                "batch_occupancy": sum(s.sizes) / max(1, len(s.sizes)),
                "sustained": (p95 <= deadline_s and loop.failed == 0
                              and left <= 2 * cfg["serving"]["max_batch"]),
            })
    finally:
        s.close()
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--deadline", type=float, default=0.25)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the sweep runs on the card", file=sys.stderr)
        return 2
    cfg = spec.config(spec.benchmark(), args.config)
    lines = sweep(cfg, args.rates, args.seconds, args.deadline, args.seed, "cuda")
    for line in lines:
        print(json.dumps(line), flush=True)
    held = [x["rate_per_s"] for x in lines if x["sustained"]]
    print(json.dumps({"config": args.config, "deadline_s": args.deadline,
                      "knee_per_s": max(held) if held else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
