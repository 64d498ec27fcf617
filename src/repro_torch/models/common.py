"""Shared model primitives: norms, RoPE, initializers.

The counterpart of ``repro.models.common``. Norms and RoPE compute in
float32 and cast back to the input's dtype, as the JAX package does (norms
in float64 for float64 inputs, a reference run).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.promote_types(dtype, torch.float32))
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * weight).to(dtype)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.promote_types(dtype, torch.float32))
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight + bias).to(dtype)


def apply_norm(kind: str, x: torch.Tensor, p: dict) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["w"])
    return layernorm(x, p["w"], p["b"])


def norm_params(kind: str, d: int, device=None) -> dict:
    if kind == "rmsnorm":
        return {"w": torch.ones((d,), device=device)}
    return {"w": torch.ones((d,), device=device), "b": torch.zeros((d,), device=device)}


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] (broadcastable). Split-halves
    layout: the first D/2 channels rotate against the last D/2."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # [D/2]
    angles = positions[..., None].float() * freqs            # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                    # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def dense_init(generator: torch.Generator | None, shape, scale: float | None = None,
               device=None) -> torch.Tensor:
    """Normal weights scaled by ``fan_in ** -0.5`` (or ``scale``), drawn
    from ``generator`` on its device; on the meta device no generator is
    needed."""
    fan_in = shape[0]
    scale = scale if scale is not None else fan_in ** -0.5
    if device is None:
        device = generator.device
    return torch.randn(shape, generator=generator, device=device) * scale


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


def activation_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "relu2": _relu2,
        "tanh": torch.tanh,
    }[name]

