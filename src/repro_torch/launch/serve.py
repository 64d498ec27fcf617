"""Serving driver: batched greedy generation on the card (or the CPU).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --reduced --device cpu --prompts "1 2 3;7 8" --max-new 8

Loads a checkpoint if given (``--ckpt-dir DIR``: the newest ``step_N`` in
DIR, written by either package's ``CheckpointManager`` as ``(params,
opt_state)`` or ``(params,)`` in the JAX package's parameter layout),
otherwise serves random weights drawn from a seeded ``torch.Generator``
(useful for throughput measurement):

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --ckpt-dir /path/to/checkpoints
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs as cfgs
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tr
from repro_torch.models.transformer_serve import ServeEngine
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import adamw_init


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--prompts", default="1 2 3;7 8")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device; 'cpu' runs on the host")
    args = ap.parse_args(argv)

    cfg = (cfgs.get_reduced_config(args.arch) if args.reduced
           else cfgs.get_config(args.arch))
    dev = resolve_device(args.device)
    params = tr.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        # training checkpoints store (params, opt_state); restore params only
        template = tr.jax_layout(cfg, params)
        try:
            (saved, _), meta = mgr.restore((template, adamw_init(template)), device=dev)
        except KeyError:
            (saved,), meta = mgr.restore((template,), device=dev)
        params = tr.params_from_jax(cfg, saved, device=dev)
        print(f"restored step {meta['step']}")
    prompts = [[int(t) for t in p.split()] for p in args.prompts.split(";")]

    eng = ServeEngine(cfg, params, max_seq=args.max_seq, device=dev)
    t0 = time.time()
    outs = eng.generate(prompts, max_new_tokens=args.max_new)
    dt = time.time() - t0
    n_tok = args.max_new * len(prompts)
    for i, o in enumerate(outs):
        print(f"[{i}] {o}")
    print(f"{n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s) on {dev}")
    return outs


if __name__ == "__main__":
    main()
