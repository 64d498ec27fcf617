"""AWB-GCN core on PyTorch: formats, schedules, SpMM, executor, GCN.

Import the submodules directly (``from repro_torch.core import schedule``);
this package imports none of them on its own, so loading one module never
pulls in the others. The tuning entry points that the JAX package's
``repro.core`` forwards (``autotune``, ``autotuned_executor``,
``get_executor``, ``graph_fingerprint``) resolve from ``repro_torch.tuning``
on first access (PEP 562).
"""

from repro_torch.lazyexports import lazy_exports

_TUNING_EXPORTS = {
    "autotune": "repro_torch.tuning.runner",
    "autotuned_executor": "repro_torch.tuning.runner",
    "get_executor": "repro_torch.tuning.registry",
    "graph_fingerprint": "repro_torch.tuning.registry",
}

__getattr__, __dir__ = lazy_exports(__name__, _TUNING_EXPORTS, globals())
