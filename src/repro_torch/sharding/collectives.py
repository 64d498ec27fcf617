"""Distributed-optimization tricks — the counterpart of
``repro.sharding.collectives``: gradient compression with error feedback,
and gradient accumulation over microbatches.

``compress_grads``/``decompress_grads`` implement int8 uniform quantization
with per-tensor scales and *error feedback* (the residual is carried to the
next step), which keeps compressed data-parallel reductions convergent
(1-bit Adam / EF-SGD lineage). Rounding is half to even in both packages
(``torch.round``, ``jnp.round``), so the int8 values are the JAX package's.
Trees are the port's nested containers (``training.tree``).
"""

from __future__ import annotations

import torch

from repro_torch.training.tree import flatten_with_paths, map_with_path, tree_map


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


@torch.no_grad()
def compress_grads(grads, error_fb):
    """Returns (int8 grads, scales, new_error_fb)."""
    def one(g, e):
        g = g.to(torch.float32) + e
        scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        err = g - q.to(torch.float32) * scale
        return q, scale, err

    flat_e = flatten_with_paths(error_fb)
    triples = {path: one(g, flat_e[path])
               for path, g in flatten_with_paths(grads).items()}
    return tuple(map_with_path(lambda path, _: triples[path][i], grads)
                 for i in range(3))


def decompress_grads(qgrads, scales):
    return tree_map(lambda q, s: q.to(torch.float32) * s, qgrads, scales)


def grad_accum_microbatches(loss_fn, params, batch, n_micro: int):
    """Gradient accumulation over ``n_micro`` microbatches, in order:
    ``loss_fn(params, microbatch)`` differentiated by autograd with respect
    to every parameter leaf; returns (mean grads in f32, mean loss)."""
    def split(x):
        b = x.shape[0]
        return x.reshape(n_micro, b // n_micro, *x.shape[1:])

    micro = tree_map(split, batch)
    flat = flatten_with_paths(params)
    gsum = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            for k, v in flat.items()}
    lsum = 0.0
    for i in range(n_micro):
        leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
        live = map_with_path(lambda path, _: leaves[path], params)
        with torch.enable_grad():
            loss = loss_fn(live, tree_map(lambda x: x[i], micro))
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        for k, g in zip(leaves, grads):
            if g is not None:
                gsum[k] = gsum[k] + g.to(torch.float32)
        lsum = lsum + loss.detach()
    inv = 1.0 / n_micro
    return map_with_path(lambda path, _: gsum[path] * inv, params), lsum * inv
