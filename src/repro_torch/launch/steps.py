"""Train / prefill / decode step factories on one device.

The counterpart of ``repro.launch.steps``. ``make_*`` return a step function
and the meta-device specs of its state (``torch.device("meta")`` tensors:
shapes and dtypes, nothing allocated), as the JAX package returns jitted
functions and ``ShapeDtypeStruct``s. They take one resolved device where the
JAX package takes a mesh: the mesh argument, the shardings and
``make_gcn_step`` come with the port's LM sharding and dry-run (ROADMAP
queue 1, item 9(c)).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tr
from repro_torch.models.common import profile_range
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.tree import flatten_with_paths, map_with_path, tree_map


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy: logsumexp of the f32 logits minus the
    label's logit, never an f32 log-softmax of the whole logits."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    lab = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - lab.float()).mean()


def _to_dtype_specs(tree, dtype):
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype, device="meta"), tree)


def _check_batch(batch: dict, batch_specs: dict) -> None:
    for key, spec in batch_specs.items():
        got = batch.get(key)
        if got is None or tuple(got.shape) != tuple(spec.shape):
            raise ValueError(f"batch[{key!r}] is "
                             f"{None if got is None else tuple(got.shape)}; the step "
                             f"was made for {tuple(spec.shape)}")


def value_and_grad(cfg: tr.ModelConfig, params: dict, batch: dict,
                   aux_weight: float = 0.01, backend: Optional[str] = None,
                   compute_dtype=torch.bfloat16) -> tuple:
    """(loss, grads): the loss cross_entropy(logits, labels) + aux_weight ·
    the MoE aux loss of ``model_forward``, and its gradient with respect to
    every parameter (zeros for one the loss does not reach), each in its
    parameter's dtype. ``backend`` selects the attention
    (``kernels.ops.attention``): the flash kernel by default on the card,
    ``"torch"`` for its plain version under autograd. The three parts run
    under the profiler ranges ``train.forward``, ``train.cross_entropy``
    and ``train.backward``."""
    flat = flatten_with_paths(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    live = map_with_path(lambda path, _: leaves[path], params)
    with torch.enable_grad():
        with profile_range("train.forward"):
            logits, aux = tr.model_forward(cfg, live, batch, backend=backend,
                                           compute_dtype=compute_dtype)
        with profile_range("train.cross_entropy"):
            loss = cross_entropy(logits, batch["labels"]) + aux_weight * aux
        with profile_range("train.backward"):
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    by_path = {k: torch.zeros_like(v) if g is None else g
               for (k, v), g in zip(leaves.items(), grads)}
    return loss.detach(), map_with_path(lambda path, _: by_path[path], params)


def make_train_step(cfg: tr.ModelConfig, device=None, batch_specs: Optional[dict] = None,
                    opt_cfg: Optional[opt_mod.AdamWConfig] = None,
                    aux_weight: float = 0.01):
    """Returns ``(train_step, (param_specs, opt_specs))``;
    ``train_step(params, opt_state, batch)`` runs the forward, the backward
    (``value_and_grad``, bf16 compute) and ``adamw_update`` on ``device``
    and returns ``(params, opt_state, metrics)``, the bf16 working
    parameters from the f32 master, ``metrics`` holding ``loss``,
    ``grad_norm`` and ``lr`` as device tensors. ``batch`` holds ``tokens``
    and ``labels`` (and ``source_embed`` for an encoder), checked against
    ``batch_specs``' shapes when given. The attention runs the flash
    kernel on the card (``_FlashAttention``). The optimizer runs under the
    profiler range ``train.optimizer``."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or opt_mod.AdamWConfig()
    param_specs = _to_dtype_specs(tr.param_specs(cfg), torch.bfloat16)
    opt_specs = opt_mod.adamw_init(param_specs)

    def train_step(params, opt_state, batch):
        if batch_specs is not None:
            _check_batch(batch, batch_specs)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        loss, grads = value_and_grad(cfg, params, batch, aux_weight)
        with profile_range("train.optimizer"):
            params, opt_state, metrics = opt_mod.adamw_update(opt_cfg, grads, opt_state)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step, (param_specs, opt_specs)


def make_prefill_step(cfg: tr.ModelConfig, device=None, batch_specs: Optional[dict] = None,
                      max_seq: int = 256):
    """Returns ``(prefill_step, (param_specs,))``; ``prefill_step(params,
    batch)`` is ``transformer.prefill`` on ``device``: (the last position's
    logits, the cache)."""
    dev = resolve_device(device)

    def prefill_step(params, batch):
        if batch_specs is not None:
            _check_batch(batch, batch_specs)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        with torch.no_grad():
            return tr.prefill(cfg, params, batch, max_seq=max_seq)

    return prefill_step, (_to_dtype_specs(tr.param_specs(cfg), torch.bfloat16),)


def make_decode_step(cfg: tr.ModelConfig, device=None, batch: int = 1,
                     max_seq: int = 256):
    """Returns ``(decode, (param_specs, cache_specs))``; ``decode(params,
    cache, token, pos)`` is ``transformer.decode_step`` on ``device``, the
    cache written in place."""
    dev = resolve_device(device)

    def decode(params, cache, token, pos):
        with torch.no_grad():
            return tr.decode_step(cfg, params, cache, torch.as_tensor(token).to(dev),
                                  int(pos))

    cache_specs = tr.init_cache(cfg, batch, max_seq, torch.bfloat16, device="meta")
    return decode, (_to_dtype_specs(tr.param_specs(cfg), torch.bfloat16), cache_specs)
