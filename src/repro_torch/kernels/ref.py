"""Plain tensor oracles for the port's kernels (SpMM and attention)."""

from __future__ import annotations

import torch

from repro_torch.core import csc as fmt
from repro_torch.core import spmm
from repro_torch.core.schedule import Schedule, execute_schedule_torch


def spmm_ref(a: fmt.COO, b: torch.Tensor) -> torch.Tensor:
    """Dense-equivalent SpMM oracle."""
    return spmm.spmm_coo(a, b)


def spmm_schedule_ref(sched: Schedule, b: torch.Tensor) -> torch.Tensor:
    """Schedule-exact oracle (same padding/epilogue semantics as kernel)."""
    return execute_schedule_torch(sched, b)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, scale: float | None = None,
                      window: int | None = None,
                      block_k: int = 2048) -> torch.Tensor:
    """Flash-style chunked attention in plain tensor ops: an online softmax
    over KV blocks that never materializes the Sq×Sk score matrix, with
    fully masked blocks skipped. Numerically ≡ ``attention_ref``."""
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    if scale is None:
        scale = d ** -0.5
    groups = h // hkv
    k = k.repeat_interleave(groups, dim=2)
    v = v.repeat_interleave(groups, dim=2)
    qf = q.float() * scale
    q_off = sk - sq

    m = torch.full((b, h, sq, 1), -1e30, device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_off
    for start in range(0, sk, block_k):
        end = min(start + block_k, sk)
        if causal and start > sq - 1 + q_off:
            continue  # block entirely in the future
        if window is not None and end - 1 <= q_off - window:
            continue  # block entirely outside every query's window
        kb = k[:, start:end].float()
        vb = v[:, start:end].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        kpos = torch.arange(start, end, device=q.device)[None, :]
        mask = torch.ones((sq, end - start), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = torch.where(mask[None, None], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(-1, keepdim=True)
        acc = corr * acc + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, scale: float | None = None,
                  window: int | None = None) -> torch.Tensor:
    """Reference multi-head attention with optional causal mask and local
    window. Shapes: q [B, Sq, H, D], k/v [B, Sk, Hkv, D]; query head h reads
    kv head h // (H/Hkv). Masked with -inf; the probabilities are cast to
    v's dtype before the PV product."""
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    if scale is None:
        scale = d ** -0.5
    groups = h // hkv
    k = k.repeat_interleave(groups, dim=2)
    v = v.repeat_interleave(groups, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None], logits, -torch.inf)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
