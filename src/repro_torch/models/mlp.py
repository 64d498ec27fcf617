"""Dense MLP: GLU-gated (SwiGLU/GeGLU) or plain two-layer.

The counterpart of ``repro.models.mlp``; the JAX package's sharding hints
are no-ops without a mesh and have no counterpart here.
"""

from __future__ import annotations

import torch

from repro_torch.models import common


def init_mlp_params(generator, d_model: int, d_ff: int, glu: bool,
                    device=None) -> dict:
    p = {
        "w_in": common.dense_init(generator, (d_model, d_ff), device=device),
        "w_out": common.dense_init(generator, (d_ff, d_model), device=device),
    }
    if glu:
        p["w_gate"] = common.dense_init(generator, (d_model, d_ff), device=device)
    return p


def mlp_forward(p: dict, x: torch.Tensor, activation: str, glu: bool) -> torch.Tensor:
    act = common.activation_fn(activation)
    h = x @ p["w_in"].to(x.dtype)
    if glu:
        h = act(x @ p["w_gate"].to(x.dtype)) * h
    else:
        h = act(h)
    return h @ p["w_out"].to(x.dtype)
