"""PEP-562 lazy module re-exports.

The counterpart of ``repro.lazyexports``. Shared by the modules that
forward the tuning entry points from ``repro_torch.tuning``
(``core/executor.py``, ``core/__init__.py``), so the forwarding mechanism,
aliases included, lives in one place.
"""

from __future__ import annotations

import importlib


def lazy_exports(module_name: str, mapping: dict, module_globals: dict):
    """Build a module's ``(__getattr__, __dir__)`` pair from ``mapping``.

    ``mapping`` sends attribute names to ``"module.path"`` (same attribute
    name there) or ``"module.path:attr"`` (alias) targets. Resolution is
    deferred to first access, so a module can forward to a package that
    itself imports the module without creating an import cycle."""

    def __getattr__(name: str):
        target = mapping.get(name)
        if target is None:
            raise AttributeError(f"module {module_name!r} has no attribute {name!r}")
        mod_path, _, attr = target.partition(":")
        return getattr(importlib.import_module(mod_path), attr or name)

    def __dir__():
        return sorted(list(module_globals) + list(mapping))

    return __getattr__, __dir__
