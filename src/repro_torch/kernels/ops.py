"""Public SpMM entry points with a backend switch.

``"cuda"`` runs the hand-written kernel (``spmm_cuda.spmm_balanced``) and is
the default for a CUDA tensor; ``"torch"`` runs its plain PyTorch version and
is the default for a CPU tensor.
"""

from __future__ import annotations

import torch

from repro_torch.core import csc as fmt
from repro_torch.core import spmm as spmm_ref_mod
from repro_torch.core.schedule import Schedule
from repro_torch.kernels import spmm_cuda as _sp

BACKENDS = ("cuda", "torch")


def default_backend(b: torch.Tensor) -> str:
    return "cuda" if b.is_cuda else "torch"


def spmm(sched: Schedule, b: torch.Tensor, *, backend: str | None = None,
         ktile: int = 128) -> torch.Tensor:
    """C = A @ B through the converged AWB schedule."""
    backend = backend or default_backend(b)
    if backend == "cuda":
        return _sp.spmm_balanced(sched, b, ktile=ktile)
    if backend == "torch":
        return _sp.spmm_balanced_plain(sched, b)
    raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")


def spmm_coo(a: fmt.COO, b: torch.Tensor) -> torch.Tensor:
    """Schedule-free reference path."""
    return spmm_ref_mod.spmm_coo(a, b)
