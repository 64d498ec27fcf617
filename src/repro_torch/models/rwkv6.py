"""RWKV-6 "Finch" block: data-dependent-decay linear attention (arXiv:
2404.05892). Attention-free: TimeMix (the wkv recurrence) + ChannelMix.

The counterpart of ``repro.models.rwkv6``. The state math per head (d_k =
d_v = head dim), with the decay acting on the key index:

    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t
    o_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)

with w_t = exp(-exp(decay_t)) data-dependent per channel (DDLerp + LoRA).

The JAX package runs the recurrence as ``lax.scan`` over time, one token a
step, which XLA compiles once. Eagerly that is a few launches a token:
4 × 2,048 tokens × 32 layers of them in rwkv6-3b's prefill. ``wkv_chunked``
runs it instead sequentially over chunks of C tokens and in parallel
inside each chunk. With A the cumulative log-decay inside a chunk, every
factor it forms is exp of a sum of log w over a span of the chunk, a decay
no greater than 1:

* the intra-chunk scores, r_t·diag(exp(A_{t-1} − A_s))·k_sᵀ for s < t,
  as a ``[.., C, C, dh]`` tensor for all chunks at once (they do not
  depend on the state);
* the carried-in state, read through r_t·exp(A_{t-1});
* each chunk's contribution to the next state, k_s·exp(A_C − A_s), and the
  state's own decay exp(A_C);
* the u bonus, the diagonal term.

Each span's sum is taken directly (``_span_sums``), never as a difference
of two running sums, so a span of weak decays after a strong one keeps its
digits. The factorised form, r·e^{A} against k·e^{−A}, would overflow f32
once a chunk's cumulative log-decay passed about −88; w0 ≥ 1.5 reaches
that within 32 tokens. Only the state's chunk-to-chunk step is a Python
loop: one ``addcmul`` a chunk. ``wkv_sequential`` is the reference's step
loop, kept as the chunked scan's plain version; it runs in float64, the
exact recurrence, because the f32 loop drifts over long runs of repeated
tokens.

``_ddlerp`` and the wkv run under ``torch.profiler`` ranges
(``rwkv.ddlerp``, ``rwkv.wkv``) while a profiler records; otherwise they
cost one flag check.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.models import common

#: tokens a chunk of ``wkv_chunked``. At rwkv6-3b's prefill shape on an
#: H100 (``chip_smoke.py``'s ``wkv_timing``; PERF.md §6), 8 took 11.1–11.2
#: ms a layer in each of four runs and 16 took 16.3–16.4; 4 took 10.6,
#: 15.3, 14.2 and 15.0: its 512 chunks a layer are twice 8's serial state
#: steps, one launch each, so its time swings with the host's
WKV_CHUNK = 8


class RWKVDims(NamedTuple):
    d_model: int
    n_heads: int
    d_head: int
    d_ff: int
    lora_r: int = 32


def init_rwkv_params(generator, dims: RWKVDims, device=None) -> dict:
    d, h, dh, r = dims.d_model, dims.n_heads, dims.d_head, dims.lora_r
    if device is None:
        device = generator.device

    def dense(shape, scale=None):
        return common.dense_init(generator, shape, scale, device=device)

    def full(shape, value):
        return torch.full(shape, value, device=device)

    return {
        # DDLerp mix coefficients (token-shift interpolation)
        "mu_x": full((d,), 0.5),
        "mu": full((5, d), 0.5),  # r, k, v, w, g
        "lora_a": dense((d, 5 * r), 0.01),
        "lora_b": dense((5, r, d), 0.01),
        # projections
        "wr": dense((d, h * dh)),
        "wk": dense((d, h * dh)),
        "wv": dense((d, h * dh)),
        "wg": dense((d, h * dh)),
        "wo": dense((h * dh, d)),
        # decay: w0 + lora
        "w0": full((h * dh,), -5.0),
        "wa": dense((d, r), 0.01),
        "wb": dense((r, h * dh), 0.01),
        # per-channel bonus
        "u": torch.zeros((h, dh), device=device),
        "ln_x": torch.ones((h * dh,), device=device),  # group norm on the output
        # channel mix
        "cm_mu_k": full((d,), 0.5),
        "cm_mu_r": full((d,), 0.5),
        "cm_wk": dense((d, dims.d_ff)),
        "cm_wv": dense((dims.d_ff, d)),
        "cm_wr": dense((d, d)),
    }


def _ddlerp(p: dict, x: torch.Tensor, x_prev: torch.Tensor) -> list:
    """Data-dependent token-shift mixing -> [xr, xk, xv, xw, xg]."""
    delta = x_prev - x
    xx = x + delta * p["mu_x"].to(x.dtype)
    lo = torch.tanh(xx @ p["lora_a"].to(x.dtype))           # [B, S, 5r]
    b, s, _ = x.shape
    lo = lo.reshape(b, s, 5, -1)
    mixes = p["mu"].to(x.dtype) + torch.einsum(
        "bsfr,frd->bsfd", lo, p["lora_b"].to(x.dtype))      # [B, S, 5, d]
    return [x + delta * mixes[:, :, i] for i in range(5)]


def wkv_sequential(r, k, v, log_w, u, state) -> tuple:
    """The reference's ``_wkv_scan``, one token a step, in float64. r, k, v,
    log_w: ``[B, S, H, dh]`` (log_w = log w_t ≤ 0); u ``[H, dh]``; state
    ``[B, H, dh, dh]``. Returns (out ``[B, S, H, dh]``, the new state) in
    r's dtype.

    Float64 because an f32 loop drifts: over a run of repeated tokens (a
    left-padded prompt) S ← w·S + kᵀv approaches its fixed point
    kᵀv/(1 − w), which an error of ε in w (its f32 rounding, or each step's)
    moves by ε/(1 − w) of itself — 150 f32 ulps at the seeded w of 0.9933.
    ``tests/test_torch_rwkv6.py`` holds both scans to a float64 loop over
    1,500 repeated tokens, where the JAX package's f32 scan drifts more than
    5× as far as the chunked one, whose decays are exponentials of sums
    taken directly.
    """
    dtype = r.dtype
    r, k, v, log_w, u, state = (t.double() for t in (r, k, v, log_w, u, state))
    w = torch.exp(log_w)
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 state + u[None, :, :, None] * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(outs, 1).to(dtype), state.to(dtype)


def _span_sums(log_w: torch.Tensor) -> tuple:
    """For log w ``[.., C, dh]`` of one chunk: the sum over the tokens
    before t (``[.., C, dh]``), over the tokens after s (``[.., C, dh]``),
    and over the tokens strictly between s and t for s < t (``[.., C, C,
    dh]``, indexed [t, s]; −inf elsewhere). Each a cumulative sum of terms
    of one sign."""
    c = log_w.shape[-2]
    zero = torch.zeros_like(log_w[..., :1, :])
    before = torch.cumsum(torch.cat([zero, log_w[..., :-1, :]], -2), -2)
    after = torch.cumsum(torch.cat([log_w[..., 1:, :], zero], -2).flip(-2), -2).flip(-2)
    t = torch.arange(c, device=log_w.device)
    # entry [t, s] holds log w_{t-1} where s < t − 1, so its cumulative sum
    # over t is the sum of log w_j over s < j < t
    shifted = torch.cat([zero, log_w[..., :-1, :]], -2)
    inner = (t[:, None] > t[None, :] + 1)[:, :, None]
    between = torch.cumsum(torch.where(inner, shifted[..., :, None, :], 0.0), -3)
    between = torch.where((t[:, None] > t[None, :])[:, :, None], between, -torch.inf)
    return before, after, between


def wkv_chunked(r, k, v, log_w, u, state, chunk: int = WKV_CHUNK) -> tuple:
    """``wkv_sequential``'s recurrence, sequential over chunks of ``chunk``
    tokens and parallel inside each (the module docstring has the form).
    The last chunk is padded with k = v = 0 and log w = 0, which leave the
    state as the last token left it."""
    b, s, h, dh = r.shape
    c = min(chunk, s)
    n = -(-s // c)
    pad = n * c - s

    def chunks(t):  # [B, S, H, dh] -> [B, H, N, C, dh]
        if pad:
            t = F.pad(t, (0, 0, 0, 0, 0, pad))
        return t.reshape(b, n, c, h, dh).permute(0, 3, 1, 2, 4)

    r, k, v, log_w = chunks(r), chunks(k), chunks(v), chunks(log_w)
    before, after, between = _span_sums(log_w)
    scores = torch.einsum("bhntk,bhnsk,bhntsk->bhnts", r, k, torch.exp(between))
    out = scores @ v + (r * u[None, :, None, None] * k).sum(-1, keepdim=True) * v
    # the state at each chunk's start, one step a chunk
    decay = torch.exp(before[..., -1, :] + log_w[..., -1, :])[..., None]  # [B, H, N, dh, 1]
    added = (k * torch.exp(after)).transpose(-1, -2) @ v                  # [B, H, N, dh, dh]
    starts = [state]
    for i in range(n - 1):
        starts.append(torch.addcmul(added[:, :, i], starts[-1], decay[:, :, i]))
    new_state = torch.addcmul(added[:, :, -1], starts[-1], decay[:, :, -1])
    out = out + (r * torch.exp(before)) @ torch.stack(starts, 2)
    out = out.permute(0, 2, 3, 1, 4).reshape(b, n * c, h, dh)[:, :s]
    return out, new_state


def rwkv_time_mix(p: dict, dims: RWKVDims, x: torch.Tensor, x_prev: torch.Tensor,
                  state: torch.Tensor, chunk: Optional[int] = WKV_CHUNK) -> tuple:
    """x: [B, S, d]; x_prev: [B, 1, d], the last token of the previous
    call; state: [B, H, dh, dh]. Returns (out, new x_prev, new state). The
    decay, the recurrence and the group norm run in f32 for f32 and bf16
    inputs, as in the JAX package, and in float64 for float64 ones (a
    reference run). The wkv runs ``wkv_chunked`` at ``chunk`` tokens a
    chunk, or ``wkv_sequential`` (its plain version) when ``chunk`` is
    None."""
    b, s, _ = x.shape
    h, dh = dims.n_heads, dims.d_head
    shifted = torch.cat([x_prev.to(x.dtype), x[:, :-1]], dim=1)
    with tracing.span("rwkv.ddlerp"):
        xr, xk, xv, xw, xg = _ddlerp(p, x, shifted)

    r = (xr @ p["wr"].to(x.dtype)).reshape(b, s, h, dh)
    k = (xk @ p["wk"].to(x.dtype)).reshape(b, s, h, dh)
    v = (xv @ p["wv"].to(x.dtype)).reshape(b, s, h, dh)
    g = F.silu(xg @ p["wg"].to(x.dtype))
    wide = torch.promote_types(x.dtype, torch.float32)
    decay = p["w0"].to(wide) + torch.tanh(xw.to(wide) @ p["wa"].to(wide)) @ p["wb"].to(wide)
    log_w = -torch.exp(decay).reshape(b, s, h, dh)  # log w, w = exp(-exp(decay))

    args = (r.to(wide), k.to(wide), v.to(wide), log_w, p["u"].to(wide), state.to(wide))
    with tracing.span("rwkv.wkv"):
        out, state = (wkv_sequential(*args) if chunk is None
                      else wkv_chunked(*args, chunk=chunk))
    # per-head group norm
    out = out * torch.rsqrt(torch.mean(out * out, -1, keepdim=True) + 1e-6)
    out = out.reshape(b, s, h * dh) * p["ln_x"]
    out = (out.to(x.dtype) * g) @ p["wo"].to(x.dtype)
    return out, x[:, -1:], state


def rwkv_channel_mix(p: dict, x: torch.Tensor, x_prev: torch.Tensor) -> tuple:
    shifted = torch.cat([x_prev.to(x.dtype), x[:, :-1]], dim=1)
    xk = x + (shifted - x) * p["cm_mu_k"].to(x.dtype)
    xr = x + (shifted - x) * p["cm_mu_r"].to(x.dtype)
    k = torch.square(F.relu(xk @ p["cm_wk"].to(x.dtype)))
    kv = k @ p["cm_wv"].to(x.dtype)
    return torch.sigmoid(xr @ p["cm_wr"].to(x.dtype)) * kv, x[:, -1:]


def init_rwkv_state(dims: RWKVDims, batch: int, device=None) -> dict:
    return {
        "tm_x": torch.zeros((batch, 1, dims.d_model), device=device),
        "cm_x": torch.zeros((batch, 1, dims.d_model), device=device),
        "wkv": torch.zeros((batch, dims.n_heads, dims.d_head, dims.d_head),
                           device=device),
    }
