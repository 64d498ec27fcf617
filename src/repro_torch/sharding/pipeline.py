"""GPipe-style pipeline parallelism over a mesh axis — the counterpart of
``repro.sharding.pipeline``.

Partition a stack of identical stages across the positions of one mesh axis
and stream microbatches through them. Schedule: classic GPipe fill-drain.
For S stages and M microbatches the loop runs ``M + S - 1`` ticks; at tick
t, stage s computes microbatch ``t - s`` (when in range) and passes its
activation to stage ``s + 1``'s position. Bubble fraction =
(S-1)/(M+S-1), reported by ``bubble_fraction`` so a launcher can size M.

Stage s's parameters live on its position only (the leading dim of every
leaf indexes the stage), so a position holds 1/S of the stack. The port's
ticks run in one process, one stage after another within a tick; the
schedule, and so each stage's inputs, are the JAX package's.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.training.tree import tree_map


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *, mesh,
                   axis: str, n_micro: int) -> torch.Tensor:
    """``y = stage_S(...stage_1(x))`` pipelined over ``axis``.

    ``stage_fn(params_slice, h) -> h`` is applied per stage; every leaf of
    ``stage_params`` has a leading dim of ``mesh.shape[axis]`` stages;
    ``x``: [B, ...] with B divisible by ``n_micro``. Stage s runs on the
    position with coordinate s on ``axis`` (0 on every other axis). Returns
    the last stage's outputs on the first stage's device."""
    n_stages = mesh.shape[axis]
    b = x.shape[0]
    if b % n_micro:
        raise ValueError("batch must divide into microbatches")
    mb = b // n_micro
    at = mesh.axis_names.index(axis)

    def device(s):
        pos = [0] * len(mesh.axis_names)
        pos[at] = s
        return mesh.device(tuple(pos))

    devices = [device(s) for s in range(n_stages)]
    params = [tree_map(lambda t, s=s: t[s].to(devices[s]), stage_params)
              for s in range(n_stages)]
    micro = x.reshape(n_micro, mb, *x.shape[1:])
    outs = [None] * n_micro
    buf = [None] * n_stages  # the activation arriving at each stage
    for t in range(n_micro + n_stages - 1):
        sent = [None] * n_stages
        for s in range(n_stages):
            if not 0 <= t - s < n_micro:
                continue
            h_in = micro[t].to(devices[0]) if s == 0 else buf[s]
            h_out = stage_fn(params[s], h_in)
            if s == n_stages - 1:
                outs[t - s] = h_out
            else:
                sent[s + 1] = h_out.to(devices[s + 1])
        buf = sent
    return torch.stack([o.to(devices[0]) for o in outs]).reshape(b, *x.shape[1:])
