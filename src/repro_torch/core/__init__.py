"""AWB-GCN core on PyTorch: formats, schedules, SpMM, executor, GCN.

The names the JAX package's ``repro.core`` exports resolve here on first
access (PEP 562): ``Schedule``, ``build_balanced_schedule``,
``build_naive_schedule`` and ``execute_schedule_torch`` (the counterpart of
``execute_schedule_jnp``) from ``core.schedule``, ``ScheduleExecutor`` from
``core.executor``, and the tuning entry points (``autotune``,
``autotuned_executor``, ``get_executor``, ``graph_fingerprint``) from
``repro_torch.tuning``. ``import repro_torch.core`` imports none of its
submodules, so loading one module never pulls in the others; import them
directly (``from repro_torch.core import schedule``) as before.
"""

from repro_torch.lazyexports import lazy_exports

# caching/tuning entry points live in repro_torch.tuning
_TUNING_EXPORTS = {
    "autotune": "repro_torch.tuning.runner",
    "autotuned_executor": "repro_torch.tuning.runner",
    "get_executor": "repro_torch.tuning.registry",
    "graph_fingerprint": "repro_torch.tuning.registry",
}

_EXPORTS = {
    "Schedule": "repro_torch.core.schedule",
    "ScheduleExecutor": "repro_torch.core.executor",
    "build_balanced_schedule": "repro_torch.core.schedule",
    "build_naive_schedule": "repro_torch.core.schedule",
    "execute_schedule_torch": "repro_torch.core.schedule",
    **_TUNING_EXPORTS,
}

__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS, globals())
