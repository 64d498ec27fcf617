"""Plain tensor oracles for the port's SpMM kernel."""

from __future__ import annotations

import torch

from repro_torch.core import csc as fmt
from repro_torch.core import spmm
from repro_torch.core.schedule import Schedule, execute_schedule_torch


def spmm_ref(a: fmt.COO, b: torch.Tensor) -> torch.Tensor:
    """Dense-equivalent SpMM oracle."""
    return spmm.spmm_coo(a, b)


def spmm_schedule_ref(sched: Schedule, b: torch.Tensor) -> torch.Tensor:
    """Schedule-exact oracle (same padding/epilogue semantics as kernel)."""
    return execute_schedule_torch(sched, b)
