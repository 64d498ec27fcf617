#!/usr/bin/env python3
"""Time the flash kernel at recurrentgemma-2b's prefill shape (B 4, S 2048,
H 10, Hkv 1, D 256, causal, window 2048), in f32 and in bf16, with the
``repro_torch`` package under ``--src``: this checkout's by default, or
another commit's unpacked tree, so that two versions compare in one call on
one card. Run from the repository root, in turns (A, B, B, A):

    git archive <commit> src/repro_torch | tar -x -C build/other
    python3 scripts/flash_ab.py --src build/other/src
    python3 scripts/flash_ab.py
    python3 scripts/flash_ab.py
    python3 scripts/flash_ab.py --src build/other/src

Each run builds that tree's kernels into its own ``build/kernels`` and
prints one JSON line: the tree, the card, and per dtype
``chip_smoke.flash_timing``'s kernel, plain-version and SDPA times (each
kernel time the mean of two runs of 20 calls) and errors."""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory holding the repro_torch package to time")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # puts this checkout's src first on sys.path
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    from repro_torch.kernels import flash_attention_cuda as tfa

    if not torch.cuda.is_available():
        print("flash_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    shape, out = (4, 2048, 2048, 10, 1, 256), {}
    for dtype in (torch.float32, torch.bfloat16):
        r = cs.flash_timing(dev, shape, True, 2048, dtype)
        out[str(dtype).replace("torch.", "")] = {
            key: r[key] for key in ("ms", "ms_runs", "plain_ms", "library_ms", "bound_ms",
                                    "max_abs_err", "max_row_rel_err")}
    print(json.dumps({"package": str(Path(tfa.__file__).resolve().parents[1]),
                      "card": cs.card_line(), "shape": shape, "timings": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
