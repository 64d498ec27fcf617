"""Architecture registry: the 10 assigned archs as data.

The counterpart of ``repro.configs``. ``get_config(name)`` returns the
published configuration; ``get_reduced_config(name)`` shrinks every
dimension for CPU tests while keeping the segment structure;
``input_specs(cfg, shape)`` gives meta-device tensors standing in for every
model input of a shape cell (shapes and dtypes, nothing allocated).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

import torch

from repro_torch.models.transformer import (EncoderConfig, ModelConfig, MoEConfig,
                                            init_cache)

_ARCH_MODULES: Dict[str, str] = {
    "rwkv6-3b": "rwkv6_3b",
    "qwen2-72b": "qwen2_72b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen2-0.5b": "qwen2_05b",
    "starcoder2-3b": "starcoder2_3b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "whisper-tiny": "whisper_tiny",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b",
    "pixtral-12b": "pixtral_12b",
}

GCN_DATASETS = ("cora", "citeseer", "pubmed", "nell", "reddit")

# shape cells: name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def list_archs():
    return list(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def cell_supported(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """The assignment's skip rules."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention"
    return True, ""


def get_reduced_config(name: str) -> ModelConfig:
    """Same family/code paths, tiny dims — for CPU tests."""
    cfg = get_config(name)
    segments = tuple((unit, min(rep, 2)) for unit, rep in cfg.segments)
    n_layers = sum(len(u) * r for u, r in segments)
    kv = min(cfg.n_kv_heads, 2)
    heads = max(4, kv * 2)
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(n_experts=8, top_k=2, d_expert=32,
                        capacity_factor=cfg.moe.capacity_factor)
    enc = None
    if cfg.encoder is not None:
        enc = EncoderConfig(n_layers=2, max_source=16)
    return dataclasses.replace(
        cfg, n_layers=n_layers, d_model=64, n_heads=heads, n_kv_heads=kv,
        d_head=16, d_ff=96, vocab=128, segments=segments, moe=moe,
        encoder=enc, window=(8 if cfg.window else None),
        d_rnn=(64 if cfg.d_rnn else 0), remat=False)


def input_specs(cfg: ModelConfig, shape: str) -> dict:
    """Meta-device stand-ins for every input of (arch × shape): int32
    ``tokens`` and ``labels`` for training, ``tokens`` for prefill, and for
    decode one ``token`` a sequence, a scalar ``pos`` and the bf16 ``cache``
    of ``init_cache`` (one dict per layer); an encoder model's bf16
    ``source_embed`` beside training and prefill inputs."""
    seq, batch, kind = SHAPES[shape]

    def spec(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    specs: dict = {}
    if kind == "train":
        specs["tokens"] = spec(batch, seq)
        specs["labels"] = spec(batch, seq)
    elif kind == "prefill":
        specs["tokens"] = spec(batch, seq)
    else:  # decode: one new token against a seq-length cache
        specs["token"] = spec(batch)
        specs["pos"] = spec()
        specs["cache"] = init_cache(cfg, batch, seq, torch.bfloat16, device="meta")
    if cfg.encoder is not None and kind != "decode":
        specs["source_embed"] = spec(batch, cfg.encoder.max_source, cfg.d_model,
                                     dtype=torch.bfloat16)
    return specs
