"""AdamW with f32 master weights — the port of ``repro.training.optimizer``.

State = ``{master f32, m, v, count}`` over the parameters' (nested) dict,
whose keys it keeps, so a checkpoint of ``(params, state)`` has the JAX
package's keys. The *working* parameters handed to the model are casts of
the master to ``param_dtype`` (bf16 by default, as in the JAX package).
Plain tensor code on the parameters' device; nothing here records an
autograd graph.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.training.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


@torch.no_grad()
def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay, as a float32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


@torch.no_grad()
def adamw_init(params) -> dict:
    """Master copy in float32, zero moments and a zero int32 step count on
    the parameters' device."""
    first = leaves(params)
    device = first[0].device if first else None
    return {
        "master": tree_map(lambda x: x.detach().to(torch.float32, copy=True), params),
        "m": tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                            device=x.device), params),
        "v": tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                            device=x.device), params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: dict,
                 param_dtype=torch.bfloat16, gnorm: Optional[torch.Tensor] = None):
    """Returns ``(new_working_params, new_state, metrics)``; the inputs are
    left as they were. ``gnorm`` (default: ``global_norm(grads)``) is the
    norm the clip reads: a sharded step passes the norm of the whole
    gradient while ``grads`` holds the shards on one device."""
    count = state["count"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    if cfg.grad_clip is not None:
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        grads = tree_map(lambda g: g.to(torch.float32) * scale, grads)
    else:
        grads = tree_map(lambda g: g.to(torch.float32), grads)

    lr = lr_schedule(cfg, count)
    b1c = 1 - cfg.b1 ** count.to(torch.float32)
    b2c = 1 - cfg.b2 ** count.to(torch.float32)

    new_m = tree_map(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g, state["m"], grads)
    new_v = tree_map(lambda v, g: cfg.b2 * v + (1 - cfg.b2) * g * g,
                     state["v"], grads)

    def upd(p, m, v):
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        return p - lr * (step + cfg.weight_decay * p)

    new_master = tree_map(upd, state["master"], new_m, new_v)
    new_params = tree_map(lambda p: p.to(param_dtype, copy=True), new_master)
    new_state = {"master": new_master, "m": new_m, "v": new_v, "count": count}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
