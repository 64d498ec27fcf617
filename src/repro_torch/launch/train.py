"""Training entry point: LM training on the card (or the CPU) with the step
factory of ``launch.steps``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --reduced --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt

The counterpart of ``repro.launch.train``, with its flags: ``--device``
defaults to the current CUDA device and takes ``cpu`` only when asked.
``--model-axis N`` (as in the JAX package) trains on a local data × model
mesh (``launch.mesh.make_local_mesh``): every card, N along ``model``; with
``--device``, N positions of that device along ``model``. Working
parameters are bf16 and the optimizer keeps the f32 master. Fault tolerance: atomic keep-2
checkpoints of (parameters, optimizer state) with the data cursor every
``--ckpt-every`` steps, in the JAX package's parameter layout, so either
package's ``CheckpointManager`` reads them and ``launch.serve --ckpt-dir``
serves them; rerunning the same command resumes from the newest complete
checkpoint.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs as cfgs
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import transformer as tr
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.sharding.spmd import unshard_tree
from repro_torch.training.tree import tree_map


def to_jax_layout(cfg: tr.ModelConfig, params: dict, opt_state: dict) -> tuple:
    """(parameters, optimizer state) with every parameter tree stacked as
    the JAX package's (``transformer.jax_layout``): the checkpoint's
    layout."""
    return tr.jax_layout(cfg, params), dict(
        opt_state, **{k: tr.jax_layout(cfg, opt_state[k]) for k in ("master", "m", "v")})


def from_jax_layout(cfg: tr.ModelConfig, saved: tuple, like: tuple, device) -> tuple:
    """The inverse of ``to_jax_layout``, each leaf in ``like``'s dtype."""
    params, opt_state = saved

    def unstack(tree, like_tree):
        return tree_map(lambda t, ref: t.to(ref.dtype),
                        tr.params_from_jax(cfg, tree, device=device), like_tree)

    return unstack(params, like[0]), dict(
        opt_state, **{k: unstack(opt_state[k], like[1][k]) for k in ("master", "m", "v")})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--model-axis", type=int, default=1,
                    help="positions along the mesh's model axis; 1: one device, no mesh")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device; 'cpu' runs on the host")
    args = ap.parse_args(argv)

    cfg = (cfgs.get_reduced_config(args.arch) if args.reduced
           else cfgs.get_config(args.arch))
    dev = resolve_device(args.device)
    mesh = None
    if args.model_axis > 1:
        devices = None if args.device is None else [args.device] * args.model_axis
        mesh = make_local_mesh(args.model_axis, devices)
        dev = mesh.device(mesh.positions()[0])
    opt_cfg = opt_mod.AdamWConfig(lr=args.lr, warmup_steps=10,
                                  total_steps=max(args.steps, 11))

    pipe = TokenPipeline(cfg.vocab, args.batch, args.seq, seed=args.seed)
    batch_specs = {k: torch.empty((args.batch, args.seq), dtype=torch.int32,
                                  device="meta") for k in ("tokens", "labels")}
    train_step, _ = steps.make_train_step(cfg, mesh or dev, batch_specs, opt_cfg=opt_cfg)

    params_f32 = tr.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed))
    params = tree_map(lambda x: x.to(torch.bfloat16), params_f32)
    opt_state = opt_mod.adamw_init(params_f32)
    del params_f32

    mgr = None
    start_step = 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=2)
        if mgr.latest_step() is not None:
            saved, meta = mgr.restore(to_jax_layout(cfg, params, opt_state), device=dev)
            params, opt_state = from_jax_layout(cfg, saved, (params, opt_state), dev)
            pipe.restore_state(meta["extra"]["pipeline"])
            start_step = meta["step"]
            print(f"resumed from step {start_step}")

    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = pipe.next_batch()
        if cfg.encoder is not None:
            batch["source_embed"] = torch.zeros(
                (args.batch, cfg.encoder.max_source, cfg.d_model))
        params, opt_state, metrics = train_step(params, opt_state, batch)
        if mesh is not None and mgr and ((step + 1) % args.ckpt_every == 0
                                         or step == args.steps - 1):
            params, opt_state = unshard_tree(params, dev), unshard_tree(opt_state, dev)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} ({dt:.1f}s)", flush=True)
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, to_jax_layout(cfg, params, opt_state),
                     extra={"pipeline": pipe.checkpoint_state()})
    if mgr:
        mgr.save(args.steps, to_jax_layout(cfg, params, opt_state),
                 extra={"pipeline": pipe.checkpoint_state()})
    print(f"first-loss {losses[0] if start_step == 0 else float('nan'):.4f} "
          f"last-loss {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
