"""Transformer serving: batched prefill + greedy decode over a static-shape
KV cache.

The counterpart of ``repro.models.transformer_serve``. Prompts are
left-padded with token 0 to a common length, with no padding mask, so
positions align; decode position ``plen + step`` past the cache's end
overwrites its last slot, as in the JAX package. Tokens stay on the device
until the end of a run, so the decode loop never waits on the host. An
encoder-decoder model (whisper) takes ``source_embed``, the ``[B, T, d]``
frame embeddings its encoder reads, with ``T`` at most ``max_source``.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tr


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


class ServeEngine:
    """Greedy generation for one model. ``backend`` selects the prefill
    attention (``kernels.ops.attention``): the flash kernel by default on
    the card, ``"torch"`` for its plain version."""

    def __init__(self, cfg: tr.ModelConfig, params: dict, max_seq: int = 256,
                 compute_dtype=torch.float32, device=None,
                 backend: Optional[str] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _to(params, self.device)
        self.max_seq = max_seq
        self.dtype = compute_dtype
        self.backend = backend
        #: host seconds of the last run's prefill and decode loop
        self.last_timing = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, prompts: List[List[int]], max_new_tokens: int = 16,
            forced: Optional[torch.Tensor] = None,
            source_embed: Optional[np.ndarray | torch.Tensor] = None) -> tuple:
        """Greedy batched generation. Returns (token lists, logits
        ``[B, max_new_tokens, vocab]``): step t's logits are those the t-th
        new token was chosen from. ``forced`` ([B, max_new_tokens]) feeds
        those tokens instead of the argmax (teacher forcing).
        ``source_embed`` is required by, and only read for, a model with an
        encoder."""
        b = len(prompts)
        plen = max(len(p) for p in prompts)
        toks = torch.zeros((b, plen), dtype=torch.long)
        for i, p in enumerate(prompts):  # right-align
            toks[i, plen - len(p):] = torch.tensor(p, dtype=torch.long)
        batch = {"tokens": toks.to(self.device)}
        if self.cfg.encoder is not None:
            if source_embed is None:
                raise ValueError(f"{self.cfg.name} has an encoder: pass source_embed, "
                                 "its [B, T, d_model] frame embeddings")
            batch["source_embed"] = torch.as_tensor(source_embed).to(self.device)
        t0 = time.perf_counter()
        logits, cache = tr.prefill(self.cfg, self.params, batch,
                                   max_seq=self.max_seq, backend=self.backend,
                                   compute_dtype=self.dtype)
        self._sync()
        t1 = time.perf_counter()
        steps, new = [logits[:, -1]], []
        for step in range(max_new_tokens):
            token = (forced[:, step].to(self.device) if forced is not None
                     else torch.argmax(steps[-1], dim=-1))
            new.append(token)
            if step == max_new_tokens - 1:
                break
            logits, cache = tr.decode_step(self.cfg, self.params, cache, token,
                                           plen + step, backend=self.backend,
                                           compute_dtype=self.dtype)
            steps.append(logits[:, -1])
        self._sync()
        self.last_timing = {"prefill_s": t1 - t0,
                            "decode_s": time.perf_counter() - t1,
                            "decode_steps": max(0, max_new_tokens - 1)}
        out = [list(p) for p in prompts]
        if new:
            for i, row in enumerate(torch.stack(new, dim=1).tolist()):
                out[i] += row
        return out, torch.stack(steps, dim=1)[:, :max_new_tokens]

    def generate(self, prompts: List[List[int]], max_new_tokens: int = 16,
                 source_embed: Optional[np.ndarray | torch.Tensor] = None
                 ) -> List[List[int]]:
        """Greedy batched generation: each prompt followed by its
        ``max_new_tokens`` new tokens."""
        return self.run(prompts, max_new_tokens, source_embed=source_embed)[0]
