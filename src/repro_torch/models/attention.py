"""GQA attention layer: RoPE, optional QKV bias, QK-norm, local window,
KV cache for prefill/decode.

The counterpart of ``repro.models.attention``. Full-sequence attention goes
through ``kernels.ops.attention`` (the flash kernel on the card). One-token
decode is plain tensor ops, as in the JAX package. Unlike the JAX package,
whose arrays are immutable, ``attn_prefill`` and ``attn_decode`` write the
cache in place and return the same dict; ``jax.lax.dynamic_update_slice``'s
clamp of an out-of-range start is mirrored, so a decode past the cache's end
overwrites its last slot in both packages.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models import common


class AttnDims(NamedTuple):
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    qkv_bias: bool
    qk_norm: bool
    rope: bool
    rope_theta: float
    window: Optional[int]
    chunk: Optional[int] = None  # chunked oracle on the CPU


def init_attn_params(generator, dims: AttnDims, device=None) -> dict:
    d, h, hkv, dh = dims.d_model, dims.n_heads, dims.n_kv_heads, dims.d_head
    if device is None:
        device = generator.device
    p = {
        "wq": common.dense_init(generator, (d, h * dh), device=device),
        "wk": common.dense_init(generator, (d, hkv * dh), device=device),
        "wv": common.dense_init(generator, (d, hkv * dh), device=device),
        "wo": common.dense_init(generator, (h * dh, d), device=device),
    }
    if dims.qkv_bias:
        p["bq"] = torch.zeros((h * dh,), device=device)
        p["bk"] = torch.zeros((hkv * dh,), device=device)
        p["bv"] = torch.zeros((hkv * dh,), device=device)
    if dims.qk_norm:
        p["q_norm"] = torch.ones((dh,), device=device)
        p["k_norm"] = torch.ones((dh,), device=device)
    return p


def _project_qkv(p: dict, dims: AttnDims, x: torch.Tensor, positions: torch.Tensor,
                 rope: bool = True):
    b, s, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if dims.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(b, s, dims.n_heads, dims.d_head)
    k = k.reshape(b, s, dims.n_kv_heads, dims.d_head)
    v = v.reshape(b, s, dims.n_kv_heads, dims.d_head)
    if dims.qk_norm:
        q = common.rmsnorm(q, p["q_norm"])
        k = common.rmsnorm(k, p["k_norm"])
    if dims.rope and rope:
        q = common.apply_rope(q, positions, dims.rope_theta)
        k = common.apply_rope(k, positions, dims.rope_theta)
    return q, k, v


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def attn_forward(p: dict, dims: AttnDims, x: torch.Tensor,
                 positions: Optional[torch.Tensor] = None, causal: bool = True,
                 backend: Optional[str] = None,
                 cross_kv: Optional[tuple] = None) -> torch.Tensor:
    """Full-sequence attention (training / encoder). x: [B, S, d].
    Cross-attention (cross_kv given) is position-free: no RoPE on q."""
    b, s, _ = x.shape
    if positions is None:
        positions = _positions(b, s, x.device)
    q, k, v = _project_qkv(p, dims, x, positions, rope=cross_kv is None)
    if cross_kv is not None:
        k, v = cross_kv
        causal = False
    out = ops.attention(q, k, v, causal=causal, window=dims.window,
                        backend=backend, chunk=dims.chunk)
    out = out.reshape(b, s, dims.n_heads * dims.d_head)
    return out @ p["wo"].to(x.dtype)


def cache_len(dims: AttnDims, max_seq: int) -> int:
    """Local-window layers keep a ring buffer of ``window`` entries."""
    return min(max_seq, dims.window) if dims.window else max_seq


def init_kv_cache(dims: AttnDims, batch: int, max_seq: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    shape = (batch, cache_len(dims, max_seq), dims.n_kv_heads, dims.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_prefill(p: dict, dims: AttnDims, x: torch.Tensor, cache: dict,
                 backend: Optional[str] = None) -> tuple:
    """Prefill: attend causally over x, write K/V into the cache (ring
    layout when the sequence outruns the cache: position s lives in slot
    s % W)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, dims, x, _positions(b, s, x.device))
    w = cache["k"].shape[1]
    if s <= w:
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
    else:  # keep the last w positions at slots (s % w)
        idx = torch.arange(s - w, s, device=x.device) % w
        cache["k"][:, idx] = k[:, -w:].to(cache["k"].dtype)
        cache["v"][:, idx] = v[:, -w:].to(cache["v"].dtype)
    out = ops.attention(q, k, v, causal=True, window=dims.window,
                        backend=backend, chunk=dims.chunk)
    out = out.reshape(b, s, dims.n_heads * dims.d_head)
    return out @ p["wo"].to(x.dtype), cache


def attn_decode(p: dict, dims: AttnDims, x: torch.Tensor, cache: dict,
                pos: int) -> tuple:
    """One-token decode. x: [B, 1, d]; ``pos`` the token's position.
    Attends over the whole static-length cache with position masking.
    Windowed layers use the ring slot ``pos % W``; others slot ``pos``,
    clamped to the last slot as ``dynamic_update_slice`` clamps it."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, device=x.device)
    q, k, v = _project_qkv(p, dims, x, positions)
    s_max = cache["k"].shape[1]
    slot = pos % s_max if dims.window else min(max(pos, 0), s_max - 1)
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    groups = dims.n_heads // dims.n_kv_heads
    kk = cache["k"].repeat_interleave(groups, dim=2).float()
    vv = cache["v"].repeat_interleave(groups, dim=2).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * (dims.d_head ** -0.5)
    # ring buffer: every written slot is within the window by construction;
    # `kpos <= pos` masks not-yet-written slots during warmup
    valid = torch.arange(s_max, device=x.device) <= pos
    logits = torch.where(valid, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vv).to(x.dtype)
    out = out.reshape(b, 1, dims.n_heads * dims.d_head)
    return out @ p["wo"].to(x.dtype), cache
