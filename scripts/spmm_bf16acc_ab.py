#!/usr/bin/env python3
"""Time the bf16-accumulate SpMM window and epilogue on reddit (232,965
nodes, seed 0) at the tuning sweep winner's geometry (K 256, R 32: the
schedule ``chip_smoke.py`` phase 6b meets), at kdim 128 and 512, with the
``repro_torch`` package under ``--src``: this checkout's by default, or
another commit's unpacked tree, so that two versions compare in one call on
one card. Run from the repository root, in turns (A, B, B, A):

    git archive <commit> src/repro_torch | tar -x -C build/other
    python3 scripts/spmm_bf16acc_ab.py --src build/other/src
    python3 scripts/spmm_bf16acc_ab.py
    python3 scripts/spmm_bf16acc_ab.py
    python3 scripts/spmm_bf16acc_ab.py --src build/other/src

Each run builds that tree's kernels into its own ``build/kernels``, makes
the adjacency (kept in ``build/ab_cache/`` for the next run) and B from
seeds, and prints one JSON line: the tree, the card, and per kdim the
window's time on an f32 B (a tree that casts B to bf16 counts its cast),
the epilogue's time on that tree's own partials, the f32 window's time in
the same run, each the mean of two runs of 10 calls, and a digest of
``spmm_balanced``'s output bytes: equal digests mean equal results."""

import argparse
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "ab_cache" / "reddit_seed0.npz"
WIDTHS = (128, 512)


def reddit_coo(fmt, synth):
    """reddit's adjacency at its published size (seed 0), from the cache
    when an earlier run made it."""
    import numpy as np
    import torch

    if CACHE.exists():
        z = np.load(CACHE)
        return fmt.COO(*(torch.from_numpy(z[k]) for k in ("row", "col", "val")),
                       tuple(int(x) for x in z["shape"]))
    nodes, _, _, _, density, _, alpha, max_deg = synth.DATASET_STATS["reddit"]
    a = synth.power_law_adjacency(nodes, density, alpha, seed=0, max_degree=max_deg)
    CACHE.parent.mkdir(parents=True, exist_ok=True)
    np.savez(CACHE, row=a.row.numpy(), col=a.col.numpy(), val=a.val.numpy(),
             shape=np.array(a.shape))
    return a


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory holding the repro_torch package to time")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # puts this checkout's src first on sys.path
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch

    from repro_torch.core import csc as fmt
    from repro_torch.core import executor as texe
    from repro_torch.core import schedule as tsched
    from repro_torch.graphs import synth
    from repro_torch.kernels import spmm_cuda

    if not torch.cuda.is_available():
        print("spmm_bf16acc_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    a = reddit_coo(fmt, synth)
    steps = texe.device_step_arrays(tsched.build_balanced_schedule(a, 256, 32), dev)
    n = a.shape[1]
    bf16, out = torch.bfloat16, {}
    for kdim in WIDTHS:
        b = torch.from_numpy(np.random.default_rng(kdim).standard_normal(
            (n, kdim)).astype(np.float32)).to(dev)
        part = spmm_cuda.spmm_window(steps, b, acc_dtype=bf16)
        got = spmm_cuda.spmm_balanced(steps, b, acc_dtype=bf16)
        window = [cs.timed_ms(lambda: spmm_cuda.spmm_window(steps, b, acc_dtype=bf16), 10)
                  for _ in range(2)]
        epilogue = [cs.timed_ms(lambda: spmm_cuda.spmm_epilogue(
            steps, part, torch.float32, acc_dtype=bf16), 10) for _ in range(2)]
        f32 = cs.timed_ms(lambda: spmm_cuda.spmm_window(steps, b), 10)
        out[str(kdim)] = {
            "window_ms": float(np.mean(window)), "window_runs_ms": window,
            "epilogue_ms": float(np.mean(epilogue)), "epilogue_runs_ms": epilogue,
            "f32_window_ms": f32, "partials_dtype": str(part.dtype),
            "output_sha256": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]}
        del b, part, got
        torch.cuda.empty_cache()
    print(json.dumps({"package": str(Path(spmm_cuda.__file__).resolve().parents[1]),
                      "card": cs.card_line(), "nnz_per_step": 256, "rows_per_window": 32,
                      "n_steps": steps.n_steps, "timings": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
