"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

The counterpart of ``repro.models.rglru``. Block: x -> (linear gate branch:
GeLU) ⊙ (linear -> causal depthwise conv1d width 4 -> RG-LRU) -> linear out.

RG-LRU per channel:
    r_t = σ(W_a x_t + b_a)        (recurrence gate)
    i_t = σ(W_x x_t + b_x)        (input gate)
    a_t = a^(c·r_t),  a = σ(Λ)    (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t²) · (i_t ⊙ x_t)

The JAX package runs the recurrence as ``lax.scan`` over time, a loop that
XLA compiles once. Eagerly, a Python loop would launch a few kernels per
token: 2,048 steps × 18 layers of them in recurrentgemma-2b's prefill. The
recurrence is linear in h, so ``_lru_scan`` runs it as a parallel scan
instead: each step is the pair (a_t, b_t) of h ↦ a_t·h + b_t, and pairs
compose associatively, (a₁, b₁) then (a₂, b₂) = (a₁a₂, a₂b₁ + b₂).
Hillis–Steele doubling takes ⌈log₂ S⌉ rounds of elementwise ops over the
whole ``[B, S, d_rnn]`` block (11 at S 2,048), and none at S 1, where
decode is one step h = a·h₀ + b. Every a_t lies in (0, 1], so the running
products only shrink toward 0: they cannot overflow, where a cumulative sum
of log a_t (down to −48 a step) would leave the f32 range of exp. The sums
associate differently from the sequential scan: f32 rounding of order
log₂ S ulps apart, far inside the decode tolerance.

The conv and the scan run under ``torch.profiler`` ranges (``rglru.conv``,
``rglru.scan``) while a profiler records; otherwise they cost one flag
check.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.models import common

_C = 8.0
CONV_WIDTH = 4


class RGLRUDims(NamedTuple):
    d_model: int
    d_rnn: int


def init_rglru_params(generator, dims: RGLRUDims, device=None) -> dict:
    d, dr = dims.d_model, dims.d_rnn
    if device is None:
        device = generator.device
    # Λ init so that a = σ(Λ)^c spreads over (0.9, 0.999)
    lam = torch.rand((dr,), generator=generator, device=device) * 4.0 + 2.0
    return {
        "w_x": common.dense_init(generator, (d, dr), device=device),
        "w_gate_branch": common.dense_init(generator, (d, dr), device=device),
        "conv_w": common.dense_init(generator, (CONV_WIDTH, dr), 0.1, device=device),
        "conv_b": torch.zeros((dr,), device=device),
        "lam": lam,
        "w_a": common.dense_init(generator, (dr, dr), device=device),
        "b_a": torch.zeros((dr,), device=device),
        "w_i": common.dense_init(generator, (dr, dr), device=device),
        "b_i": torch.zeros((dr,), device=device),
        "w_out": common.dense_init(generator, (dr, d), device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: torch.Tensor) -> tuple:
    """Depthwise causal conv width 4. x: [B, S, dr]; conv_state: [B, 3, dr]
    (the previous 3 inputs). Returns (y, new_conv_state in f32), summing
    the taps in x's dtype in the JAX package's order."""
    s = x.shape[1]
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    y = xp[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, CONV_WIDTH):
        y = y + xp[:, i:i + s] * w[i].to(x.dtype)
    new_state = xp[:, -(CONV_WIDTH - 1):].float().clone()  # not a view into xp
    return y + b.to(x.dtype), new_state


def _replace(x: torch.Tensor, start: int, stop: int, value: torch.Tensor,
             in_place: bool) -> torch.Tensor:
    """x with positions ``start:stop`` along S set to ``value``: written into
    x when ``in_place``, else a new tensor (autograd cannot differentiate a
    tensor written after use)."""
    if in_place:
        x[:, start:stop] = value
        return x
    return torch.cat([x[:, :start], value, x[:, stop:]], 1)


def _lru_scan(a_t: torch.Tensor, gated: torch.Tensor, h0: torch.Tensor) -> tuple:
    """h_t = a_t h_{t-1} + sqrt(1 - a_t²) gated_t over S (f32, [B, S, dr]),
    as a Hillis–Steele scan of the pairs (a_t, b_t). Returns (hs, h_last).
    Without grad (serving) each round writes its buffers in place, which
    moves fewer bytes; with grad (training) each round makes new ones, the
    same sums in the same order."""
    in_place = not (torch.is_grad_enabled()
                    and any(t.requires_grad for t in (a_t, gated, h0)))
    b = torch.sqrt(torch.clamp(1.0 - a_t * a_t, min=0.0)) * gated
    # step 1 carries the state in
    b = _replace(b, 0, 1, torch.addcmul(b[:, :1], a_t[:, :1], h0[:, None]), in_place)
    a = a_t.clone() if in_place else a_t
    s, shift = a.shape[1], 1
    while shift < s:
        # position t composes its span with the one ending at t - shift
        b = _replace(b, shift, s, torch.addcmul(b[:, shift:], a[:, shift:], b[:, :-shift]),
                     in_place)
        if 2 * shift < s:  # the last round's products are never read
            a = _replace(a, shift, s, a[:, shift:] * a[:, :-shift], in_place)
        shift *= 2
    return b, b[:, -1].clone()  # not a view that keeps all of b alive


def rglru_forward(p: dict, dims: RGLRUDims, x: torch.Tensor, state: dict) -> tuple:
    """x: [B, S, d]; state {'h': [B, dr], 'conv': [B, 3, dr]} (f32). Returns
    (out [B, S, d] in x's dtype, the new state)."""
    gate = F.gelu(x @ p["w_gate_branch"].to(x.dtype), approximate="tanh")
    u = x @ p["w_x"].to(x.dtype)
    with tracing.span("rglru.conv"):
        u, conv_state = _causal_conv(u, p["conv_w"], p["conv_b"], state["conv"])

    uf = u.float()
    r = torch.sigmoid(uf @ p["w_a"] + p["b_a"])
    i = torch.sigmoid(uf @ p["w_i"] + p["b_i"])
    # log σ(Λ)^(c·r), with jax.nn.softplus's logaddexp(Λ, 0)
    log_a = -_C * r * torch.logaddexp(p["lam"], torch.zeros_like(p["lam"]))
    a_t = torch.exp(log_a)
    with tracing.span("rglru.scan"):
        hs, h_last = _lru_scan(a_t, i * uf, state["h"].float())

    out = (hs.to(x.dtype) * gate) @ p["w_out"].to(x.dtype)
    return out, {"h": h_last, "conv": conv_state}


def init_rglru_state(dims: RGLRUDims, batch: int, device=None) -> dict:
    return {
        "h": torch.zeros((batch, dims.d_rnn), device=device),
        "conv": torch.zeros((batch, CONV_WIDTH - 1, dims.d_rnn), device=device),
    }
