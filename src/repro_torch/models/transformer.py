"""Model assembly for the assigned architectures.

The counterpart of ``repro.models.transformer``. A model is a stack of
*segments*, each a repeating *unit* of layer kinds. The JAX package scans
stacked per-segment parameters; the port unrolls the stack into a Python
list of per-layer parameter dicts (``params["layers"]``) and loops over it,
and keeps an encoder's layers likewise in ``params["encoder"]``. The layer
kinds:

  ``attn``      global causal GQA attention + dense MLP
  ``local``     windowed attention + dense MLP
  ``attn_moe``  attention + MoE FFN (AWB-balanced dispatch, ``models.moe``)
  ``rwkv``      RWKV-6 TimeMix + ChannelMix, attention-free (``models.rwkv6``)
  ``rglru``     RG-LRU recurrent block + dense MLP (``models.rglru``)
  ``xattn``     decoder layer with cross-attention to the encoder (enc-dec)
  ``enc``       bidirectional encoder layer + dense MLP

Entry points: ``model_forward`` (full sequence; training differentiates
it), ``prefill`` (build the cache) and ``decode_step`` (one token). With
``cfg.remat`` and grad enabled, ``model_forward`` checkpoints each decoder
layer (``torch.utils.checkpoint``), as the JAX package checkpoints each
scanned unit: the backward recomputes the layer's forward. An
encoder-decoder model reads ``batch["source_embed"]`` ([B, T, d] frame
embeddings). Caches are a list with one dict per layer: ``{"k", "v"}`` for
attention, plus ``{"xk", "xv"}`` (the encoder's keys and values, zero-padded
to ``max_source``) for ``xattn``, ``{"h", "conv"}`` in f32 for ``rglru`` and
``{"tm_x", "cm_x", "wkv"}`` in f32 for ``rwkv``. Decode attends to the whole
padded ``xk``/``xv`` with no mask, as the JAX package does: with fewer than
``max_source`` frames the zero keys take part in the softmax. A recurrent
layer's decode is its prefill at S 1. ``backend="torch"`` runs every
kernel's plain version: the plain attention, and the sequential wkv
(``rwkv6.wkv_sequential``) in place of the chunked scan.
``model_forward`` returns the sum of the MoE layers' aux losses beside the
logits; decode runs the MoE dropless (capacity ``B·S·top_k``), as the JAX
package does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import common
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.attention import (AttnDims, attn_decode, attn_forward,
                                          attn_prefill, init_attn_params,
                                          init_kv_cache)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    capacity_factor: float = 1.25
    n_slots: int = 0  # 0 => n_experts; > n_experts enables AWB replication


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    n_layers: int
    max_source: int = 1500  # whisper audio frames after conv stem


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    segments: Tuple[Tuple[Tuple[str, ...], int], ...]
    d_head: int = 0              # 0 => d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope: bool = True
    rope_theta: float = 1e4
    activation: str = "silu"
    glu: bool = True
    norm: str = "rmsnorm"
    moe: Optional[MoEConfig] = None
    window: Optional[int] = None
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[str] = None   # audio | vision
    tie_embeddings: bool = False
    remat: bool = True
    d_rnn: int = 0               # 0 => d_model (rglru width)
    attn_chunk: Optional[int] = None   # chunked attention oracle on the CPU
    moe_groups: int = 1
    sp_carry: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def rnn_width(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def sub_quadratic(self) -> bool:
        """True when no layer needs unwindowed attention over the full
        sequence (long_500k eligibility)."""
        kinds = [k for unit, rep in self.segments for k in unit]
        return all(k in ("rwkv", "rglru", "local") for k in kinds)

    def attn_dims(self, window: Optional[int]) -> AttnDims:
        return AttnDims(self.d_model, self.n_heads, self.n_kv_heads,
                        self.head_dim, self.qkv_bias, self.qk_norm,
                        self.rope, self.rope_theta, window, self.attn_chunk)

    @property
    def rwkv_dims(self) -> rwkv_mod.RWKVDims:
        return rwkv_mod.RWKVDims(self.d_model, self.n_heads, self.head_dim, self.d_ff)

    @property
    def rglru_dims(self) -> rglru_mod.RGLRUDims:
        return rglru_mod.RGLRUDims(self.d_model, self.rnn_width)

    @property
    def moe_dims(self) -> moe_mod.MoEDims:
        m = self.moe
        return moe_mod.MoEDims(self.d_model, m.d_expert, m.n_experts,
                               m.top_k, m.capacity_factor, self.activation,
                               self.glu, m.n_slots, self.moe_groups)


_KINDS = ("attn", "local", "attn_moe", "rwkv", "rglru", "xattn", "enc")


def layer_kinds(cfg: ModelConfig) -> list:
    """The kind of every decoder layer, in order, with each segment
    unrolled (an encoder's layers are all ``enc``)."""
    kinds = [kind for unit, repeat in cfg.segments for _ in range(repeat)
             for kind in unit]
    for kind in kinds:
        if kind not in _KINDS:
            raise ValueError(f"unknown layer kind {kind}")
    return kinds


def _window(cfg: ModelConfig, kind: str) -> Optional[int]:
    return cfg.window if kind == "local" else None


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _init_layer(cfg: ModelConfig, kind: str, generator, device) -> dict:
    p = {"norm1": common.norm_params(cfg.norm, cfg.d_model, device)}
    if kind == "rwkv":  # TimeMix and ChannelMix, no MLP
        p["rwkv"] = rwkv_mod.init_rwkv_params(generator, cfg.rwkv_dims, device)
        p["norm2"] = common.norm_params(cfg.norm, cfg.d_model, device)
        return p
    if kind == "rglru":
        p["rec"] = rglru_mod.init_rglru_params(generator, cfg.rglru_dims, device)
    else:
        p["attn"] = init_attn_params(generator, cfg.attn_dims(_window(cfg, kind)),
                                     device)
    p["norm2"] = common.norm_params(cfg.norm, cfg.d_model, device)
    if kind == "xattn":
        p["xnorm"] = common.norm_params(cfg.norm, cfg.d_model, device)
        p["xattn"] = init_attn_params(generator, cfg.attn_dims(None), device)
        p["norm3"] = common.norm_params(cfg.norm, cfg.d_model, device)
    if kind == "attn_moe":
        p["moe"] = moe_mod.init_moe_params(generator, cfg.moe_dims, device)
    else:
        p["mlp"] = mlp_mod.init_mlp_params(generator, cfg.d_model, cfg.d_ff, cfg.glu,
                                           device)
    return p


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device=None) -> dict:
    """Random parameters drawn from ``generator`` on its device. The meta
    device (``generator=None, device="meta"``) allocates nothing."""
    if device is None:
        device = generator.device
    params = {
        "embed": torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                             device=device) * 0.02,
        "final_norm": common.norm_params(cfg.norm, cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = common.dense_init(generator, (cfg.d_model, cfg.vocab),
                                              device=device)
    params["layers"] = [_init_layer(cfg, kind, generator, device)
                        for kind in layer_kinds(cfg)]
    if cfg.encoder is not None:
        params["encoder"] = [_init_layer(cfg, "enc", generator, device)
                             for _ in range(cfg.encoder.n_layers)]
        params["enc_norm"] = common.norm_params(cfg.norm, cfg.d_model, device)
    return params


def param_specs(cfg: ModelConfig) -> dict:
    """The parameters as meta-device tensors: their shapes and dtypes,
    with nothing allocated (the JAX package's ``eval_shape`` specs)."""
    return init_params(cfg, None, device="meta")


def _leaves(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    elif isinstance(tree, list):
        for value in tree:
            yield from _leaves(value)
    else:
        yield tree


def count_params(cfg: ModelConfig) -> int:
    return sum(t.numel() for t in _leaves(param_specs(cfg)))


def active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: top_k of n_experts)."""
    total = count_params(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    n_moe_layers = sum(rep * sum(1 for k in unit if k == "attn_moe")
                       for unit, rep in cfg.segments)
    per_expert = cfg.d_model * m.d_expert * (3 if cfg.glu else 2)
    inactive = n_moe_layers * per_expert * (m.n_experts - m.top_k)
    return total - inactive


def params_from_jax(cfg: ModelConfig, np_params: dict, device=None) -> dict:
    """The port's parameters from the JAX package's parameter pytree as
    numpy arrays (or tensors, as a checkpoint restores them): each
    ``seg{i}`` leaf carries a leading ``repeat`` axis, split here into one
    dict per layer, and likewise the encoder's stacked ``encoder/l0``."""
    dev = resolve_device(device)

    def tensor(a):
        if isinstance(a, torch.Tensor):
            return a.to(dev, torch.float32)
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    def take(tree, r):
        if isinstance(tree, dict):
            return {k: take(v, r) for k, v in tree.items()}
        if not isinstance(tree, torch.Tensor):
            tree = np.asarray(tree)
        return tensor(tree[r])

    layer_kinds(cfg)  # raises on kinds the port does not run
    params = {"embed": tensor(np_params["embed"]),
              "final_norm": {k: tensor(v) for k, v in np_params["final_norm"].items()}}
    if not cfg.tie_embeddings:
        params["lm_head"] = tensor(np_params["lm_head"])
    layers = []
    for si, (unit, repeat) in enumerate(cfg.segments):
        seg = np_params[f"seg{si}"]
        for r in range(repeat):
            layers += [take(seg[f"l{i}"], r) for i in range(len(unit))]
    params["layers"] = layers
    if cfg.encoder is not None:
        enc = np_params["encoder"]["l0"]
        params["encoder"] = [take(enc, r) for r in range(cfg.encoder.n_layers)]
        params["enc_norm"] = {k: tensor(v) for k, v in np_params["enc_norm"].items()}
    return params


def jax_layout(cfg: ModelConfig, params: dict) -> dict:
    """The port's parameters in the JAX package's layout, the inverse of
    ``params_from_jax``: each segment's unit layers stacked along a leading
    ``repeat`` axis as ``seg{i}/l{j}``, the encoder's as ``encoder/l0``.
    Checkpoints use this layout."""

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    out = {k: v for k, v in params.items() if k not in ("layers", "encoder")}
    if "encoder" in params:
        out["encoder"] = {"l0": stack(params["encoder"])}
    layers, at = params["layers"], 0
    for si, (unit, repeat) in enumerate(cfg.segments):
        n = len(unit)
        out[f"seg{si}"] = {
            f"l{i}": stack([layers[at + r * n + i] for r in range(repeat)])
            for i in range(n)
        }
        at += n * repeat
    return out


# ---------------------------------------------------------------------------
# Forward (full sequence)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerOps:
    """The calls a layer makes for its self-attention, its dense MLP and its
    MoE, with the signatures of ``attention.attn_forward``, ``attn_prefill``,
    ``attn_decode``, ``mlp.mlp_forward`` and ``moe.moe_forward``. ``PLAIN``
    is the model's own; a sharded step (``sharding.spmd.Run.ops``) passes
    versions that split the attention and the MLP over a mesh's model
    positions, reading ``p["attn"]``/``p["mlp"]`` as it gathered them, and
    route each data position's MoE tokens as part of the whole batch."""
    attn_forward: Callable = attn_forward
    attn_prefill: Callable = attn_prefill
    attn_decode: Callable = attn_decode
    mlp_forward: Callable = mlp_mod.mlp_forward
    moe_forward: Callable = moe_mod.moe_forward


PLAIN = LayerOps()


def _norm(cfg, p, x):
    return common.apply_norm(cfg.norm, x, p)


def _ffn(cfg, kind, p, x, capacity_override=None, ops: LayerOps = PLAIN) -> tuple:
    """The layer's last residual block, dense MLP or MoE, after ``norm3``
    in an ``xattn`` layer and ``norm2`` otherwise. Returns (x, the MoE's aux
    loss or None)."""
    h = _norm(cfg, p["norm3" if kind == "xattn" else "norm2"], x)
    if kind == "attn_moe":
        out, aux = ops.moe_forward(p["moe"], cfg.moe_dims, h,
                                   capacity_override=capacity_override)
        return x + out, aux
    return x + ops.mlp_forward(p["mlp"], h, cfg.activation, cfg.glu), None


def _recurrent(cfg, p, x, state, ops: LayerOps = PLAIN) -> tuple:
    """An ``rglru`` layer from ``state``: (x, the new state)."""
    h, state = rglru_mod.rglru_forward(p["rec"], cfg.rglru_dims,
                                       _norm(cfg, p["norm1"], x), state)
    x, _ = _ffn(cfg, "rglru", p, x + h, ops=ops)
    return x, state


def _rwkv(cfg, p, x, state, backend) -> tuple:
    """An ``rwkv`` layer from ``state`` ({tm_x, cm_x, wkv}): (x, the new
    state in f32 — float64 in a float64 run — as copies that keep no
    activation alive)."""
    dims = cfg.rwkv_dims
    wide = torch.promote_types(x.dtype, torch.float32)
    chunk = None if backend == "torch" else rwkv_mod.WKV_CHUNK
    h, tm_x, wkv = rwkv_mod.rwkv_time_mix(p["rwkv"], dims, _norm(cfg, p["norm1"], x),
                                          state["tm_x"].to(x.dtype), state["wkv"],
                                          chunk)
    x = x + h
    h, cm_x = rwkv_mod.rwkv_channel_mix(p["rwkv"], _norm(cfg, p["norm2"], x),
                                        state["cm_x"].to(x.dtype))
    return x + h, {"tm_x": tm_x.to(wide, copy=True), "cm_x": cm_x.to(wide, copy=True),
                   "wkv": wkv}


def _cross_kv(cfg, p, enc_out) -> tuple:
    """The cross-attention's keys and values from the encoder output (no
    bias, no RoPE), [B, T, Hkv, D] each."""
    b, s_enc, _ = enc_out.shape
    dims = cfg.attn_dims(None)
    shape = (b, s_enc, dims.n_kv_heads, dims.d_head)
    return ((enc_out @ p["xattn"]["wk"].to(enc_out.dtype)).reshape(shape),
            (enc_out @ p["xattn"]["wv"].to(enc_out.dtype)).reshape(shape))


def _cross(cfg, p, x, k, v, backend) -> torch.Tensor:
    """x plus the cross-attention over (k, v): non-causal, q without RoPE."""
    return x + attn_forward(p["xattn"], cfg.attn_dims(None), _norm(cfg, p["xnorm"], x),
                            causal=False, backend=backend, cross_kv=(k, v))


def _encode(cfg: ModelConfig, params: dict, batch: dict, dtype, backend,
            ops: LayerOps = PLAIN):
    """The encoder's output for ``batch["source_embed"]`` (bidirectional
    attention with RoPE on frame positions), or None without an encoder."""
    if cfg.encoder is None:
        return None
    x = batch["source_embed"].to(dtype)
    for p in params["encoder"]:
        x, _ = _layer(cfg, "enc", p, x, None, backend, ops)
    return _norm(cfg, params["enc_norm"], x)


def _embed(params: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    # gather then cast: the same values as the JAX package's cast then gather
    return params["embed"][tokens.long()].to(dtype)


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = _norm(cfg, params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


def _layer(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor, enc_out,
           backend, ops: LayerOps = PLAIN) -> tuple:
    """One decoder (or ``enc``) layer of ``model_forward``, a recurrent one
    from a zero state: (x, the MoE's aux loss or None)."""
    if kind == "rglru":
        state = rglru_mod.init_rglru_state(cfg.rglru_dims, x.shape[0], x.device)
        return _recurrent(cfg, p, x, state, ops)[0], None
    if kind == "rwkv":
        state = rwkv_mod.init_rwkv_state(cfg.rwkv_dims, x.shape[0], x.device)
        return _rwkv(cfg, p, x, state, backend)[0], None
    x = x + ops.attn_forward(p["attn"], cfg.attn_dims(_window(cfg, kind)),
                             _norm(cfg, p["norm1"], x), causal=kind != "enc",
                             backend=backend)
    if kind == "xattn":
        x = _cross(cfg, p, x, *_cross_kv(cfg, p, enc_out), backend)
    return _ffn(cfg, kind, p, x, ops=ops)


def model_forward(cfg: ModelConfig, params: dict, batch: dict,
                  backend: Optional[str] = None,
                  compute_dtype=torch.bfloat16, ops: LayerOps = PLAIN) -> tuple:
    """batch: {'tokens': [B, S] int, optional 'source_embed': [B, T, d]}.
    Returns (logits [B, S, vocab], aux_loss): the sum of the MoE layers'
    aux losses, 0 without one. ``params["layers"]`` may be any sequence
    that yields each layer's parameters as it is read (a sharded step's
    gathers, ``sharding.spmd.Run.at``)."""
    x = _embed(params, batch["tokens"], compute_dtype)
    enc_out = _encode(cfg, params, batch, compute_dtype, backend, ops)
    aux_total = torch.zeros((), device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for kind, p in zip(layer_kinds(cfg), params["layers"]):
        if remat:
            x, aux = checkpoint(_layer, cfg, kind, p, x, enc_out, backend, ops,
                                use_reentrant=False)
        else:
            x, aux = _layer(cfg, kind, p, x, enc_out, backend, ops)
        if aux is not None:
            aux_total = aux_total + aux
    return _logits(cfg, params, x), aux_total


# ---------------------------------------------------------------------------
# Cache init / prefill / decode
# ---------------------------------------------------------------------------


def _init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int, dtype,
                      device) -> dict:
    if kind == "rglru":
        return rglru_mod.init_rglru_state(cfg.rglru_dims, batch, device)
    if kind == "rwkv":
        return rwkv_mod.init_rwkv_state(cfg.rwkv_dims, batch, device)
    c = init_kv_cache(cfg.attn_dims(_window(cfg, kind)), batch, max_seq, dtype, device)
    if kind == "xattn":
        dims = cfg.attn_dims(None)
        shape = (batch, cfg.encoder.max_source, dims.n_kv_heads, dims.d_head)
        c["xk"] = torch.zeros(shape, dtype=dtype, device=device)
        c["xv"] = torch.zeros(shape, dtype=dtype, device=device)
    return c


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None) -> list:
    return [_init_layer_cache(cfg, kind, batch, max_seq, dtype, device)
            for kind in layer_kinds(cfg)]


def _layer_prefill(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor, c: dict,
                   enc_out, backend, ops: LayerOps = PLAIN) -> torch.Tensor:
    """One decoder layer of ``prefill``: x after the layer, its cache ``c``
    written in place."""
    if kind == "rglru":
        x, state = _recurrent(cfg, p, x, c, ops)
        c.update(state)
        return x
    if kind == "rwkv":
        x, state = _rwkv(cfg, p, x, c, backend)
        c.update(state)
        return x
    h, _ = ops.attn_prefill(p["attn"], cfg.attn_dims(_window(cfg, kind)),
                            _norm(cfg, p["norm1"], x), c, backend)
    x = x + h
    if kind == "xattn":
        x = _cross_prefill(cfg, p, x, c, enc_out, backend)
    return _ffn(cfg, kind, p, x, ops=ops)[0]


def _cross_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor, c: dict, enc_out,
                   backend) -> torch.Tensor:
    """An ``xattn`` layer's cross-attention in the prefill: the encoder's
    keys and values written into ``c["xk"]``/``c["xv"]`` (the frames past
    the encoder's stay zero)."""
    k, v = _cross_kv(cfg, p, enc_out)
    s_enc = k.shape[1]
    if s_enc > c["xk"].shape[1]:
        raise ValueError(f"{s_enc} source frames exceed max_source "
                         f"{c['xk'].shape[1]}")
    c["xk"][:, :s_enc] = k
    c["xv"][:, :s_enc] = v
    return _cross(cfg, p, x, k, v, backend)


def prefill(cfg: ModelConfig, params: dict, batch: dict, max_seq: int,
            backend: Optional[str] = None, compute_dtype=torch.bfloat16) -> tuple:
    """Run the prompt (and the encoder over ``batch["source_embed"]``);
    return (logits at the last position [B, 1, vocab], cache)."""
    tokens = batch["tokens"]
    x = _embed(params, tokens, compute_dtype)
    enc_out = _encode(cfg, params, batch, compute_dtype, backend)
    cache = init_cache(cfg, tokens.shape[0], max_seq, compute_dtype, x.device)
    for kind, p, c in zip(layer_kinds(cfg), params["layers"], cache):
        x = _layer_prefill(cfg, kind, p, x, c, enc_out, backend)
    return _logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params: dict, cache: list, token: torch.Tensor,
                pos: int, backend: Optional[str] = None,
                compute_dtype=torch.bfloat16) -> tuple:
    """token: [B] int; pos: the token's position. Returns (logits [B, 1, V],
    cache), the cache written in place. Self-attention decode is plain
    tensor ops (as in the JAX package); ``backend`` selects the
    cross-attention over the cached encoder keys (``kernels.ops.attention``)
    and the wkv's version. The MoE runs dropless: capacity ``B·top_k`` per
    slot."""
    x = _embed(params, token, compute_dtype)[:, None]
    dropless = x.shape[0] * x.shape[1] * cfg.moe.top_k if cfg.moe else None
    for kind, p, c in zip(layer_kinds(cfg), params["layers"], cache):
        x = _layer_decode(cfg, kind, p, x, c, pos, backend, dropless)
    return _logits(cfg, params, x), cache


def _layer_decode(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor, c: dict,
                  pos: int, backend, dropless, ops: LayerOps = PLAIN) -> torch.Tensor:
    """One decoder layer of ``decode_step``: x after the layer, its cache
    ``c`` written in place."""
    # a recurrent layer's decode is its prefill at S 1
    if kind in ("rglru", "rwkv"):
        return _layer_prefill(cfg, kind, p, x, c, None, backend, ops)
    h, _ = ops.attn_decode(p["attn"], cfg.attn_dims(_window(cfg, kind)),
                           _norm(cfg, p["norm1"], x), c, pos)
    x = x + h
    if kind == "xattn":
        x = _cross(cfg, p, x, c["xk"].to(x.dtype), c["xv"].to(x.dtype), backend)
    return _ffn(cfg, kind, p, x, capacity_override=dropless, ops=ops)[0]
