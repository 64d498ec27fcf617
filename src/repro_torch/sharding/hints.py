"""Activation-sharding hints — the counterpart of ``repro.sharding.hints``.

The JAX package's step factories install the current mesh and axis names
here, and its model code calls ``constrain(x, ("dp", None, "tp"))`` at the
Megatron points so GSPMD shards activations as intended. The port has no
compiler to steer: its sharded steps (``launch.steps``) place every shard
on its position themselves, so ``constrain`` returns its input unchanged
and the port's models never call it. What the port does read is a step's
flags: the sharded decode asks ``get_flag("kv_seq_shard")``, as the JAX
package's attention does.
"""

from __future__ import annotations

import contextlib
import threading

_STATE = threading.local()


def set_hints(mesh, dp, tp, **flags) -> None:
    _STATE.value = (mesh, dp, tp, flags)


def clear_hints() -> None:
    _STATE.value = None


@contextlib.contextmanager
def hints(mesh, dp, tp, **flags):
    prev = getattr(_STATE, "value", None)
    set_hints(mesh, dp, tp, **flags)
    try:
        yield
    finally:
        _STATE.value = prev


def get_flag(name: str, default=None):
    h = getattr(_STATE, "value", None)
    if h is None:
        return default
    return h[3].get(name, default)


def constrain(x, dims: tuple):
    """``x`` itself: the step that runs the model places the shards. dims
    entries: 'dp' | 'tp' | None (one per array dim), as in the JAX
    package."""
    if len(dims) != x.dim():
        raise ValueError(f"{len(dims)} dims named for a {x.dim()}-d tensor")
    return x
