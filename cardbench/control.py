"""The readings that the limit of a cell's check is set from, in one process.

    python3 cardbench/control.py --workload <cell> --seeds 1 2 3 [--seconds 2]

For each seed, two runs of the cell through ``run.run_cell``, each with a
short window at the cell's own load: the program as its configuration
states it (f32, TF32 off), and the control: the same program with its TF32
path switched on (``"tf32": true``, cuBLAS's X·W on TF32 tensor cores), the
step below the configuration's f32 that would tempt a change. Each run's
``correct`` and the numbers its check compared are printed, one JSON line
per seed, then the program's highest and the control's lowest reading. The
program has to come out correct and the control not: the command exits 1
where either does not. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                    str(Path(__file__).resolve().parents[1])]

import torch  # noqa: E402

from cardbench import spec  # noqa: E402

#: the control's change to the configuration
CONTROL = {"tf32": True}


def reading(name: str, seed: int, seconds: float, control: bool, *,
            root: Path = spec.ROOT, device="cuda") -> dict:
    """One run of cell ``name``, as stated or as the control: its
    ``correct`` and each number its check compared."""
    from cardbench import run

    bench = spec.benchmark(root)
    cfg = spec.config(bench, spec.workload(bench, name)["config"], root)
    if control and cfg["tf32"]:
        raise ValueError(f"{cfg['name']} states TF32 already: no TF32 control")
    r = run.run_cell(name, seed, seconds, False, root=root, device=device,
                     t_start=time.perf_counter(),
                     config_over=CONTROL if control else None)
    return {"correct": r["correct"], **{k: c["value"] for k, c in r["checks"].items()},
            "limit": r["checks"]["logits_rel_err"]["limit"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    lines = []
    for seed in args.seeds:
        line = {"workload": args.workload, "seed": seed,
                "program": reading(args.workload, seed, args.seconds, False),
                "control_tf32": reading(args.workload, seed, args.seconds, True)}
        lines.append(line)
        print(json.dumps(line), flush=True)
    prog = [x["program"] for x in lines]
    ctrl = [x["control_tf32"] for x in lines]
    print(json.dumps({
        "workload": args.workload, "limit": prog[0]["limit"],
        "program_max": max(x["logits_rel_err"] for x in prog),
        "control_min": min(x["logits_rel_err"] for x in ctrl),
        "program_correct": sum(x["correct"] for x in prog),
        "control_correct": sum(x["correct"] for x in ctrl), "seeds": len(lines)}),
        flush=True)
    return 0 if all(x["correct"] for x in prog) and not any(
        x["correct"] for x in ctrl) else 1


if __name__ == "__main__":
    sys.exit(main())
