"""Training substrate of the port: ``optimizer`` (AdamW with f32 master
weights), ``checkpoint`` (atomic, keep-k, async; the JAX package's on-disk
format) and ``tree`` (nested dicts of tensors keyed as its pytrees)."""
from repro_torch.training.optimizer import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
)
