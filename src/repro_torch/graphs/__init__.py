"""Synthetic graph datasets calibrated to the paper's Table I.

``DATASET_STATS``, ``GraphDataset``, ``make_dataset`` and
``power_law_adjacency`` resolve from ``graphs.synth`` on first access
(PEP 562), as the JAX package's ``repro.graphs`` exports them;
``import repro_torch.graphs`` imports no submodule.
"""

from repro_torch.lazyexports import lazy_exports

_EXPORTS = {
    "DATASET_STATS": "repro_torch.graphs.synth",
    "GraphDataset": "repro_torch.graphs.synth",
    "make_dataset": "repro_torch.graphs.synth",
    "power_law_adjacency": "repro_torch.graphs.synth",
}

__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS, globals())
