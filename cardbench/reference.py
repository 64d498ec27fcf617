"""The plain reference of the GCN forward pass, ``Z = A·ReLU(A·(X·W0))·W1``
with the paper's A·(X·W) order on every layer.

Plain PyTorch in float32 with TF32 off: the dense product is ``torch.mm``,
the sparse one ``index_add_`` over the harness's own COO arrays, in blocks
of non-zeros so that it fits beside the program's state. It takes nothing
the program derived (no schedule, permutation or upload).
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch

BLOCK_NNZ = 1 << 22


@contextlib.contextmanager
def _no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    with _no_tf32():
        return x @ w


def spmm(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, m: int,
         b: torch.Tensor, block: int = BLOCK_NNZ) -> torch.Tensor:
    """``A @ b`` for A given as COO arrays, by ``index_add_`` in blocks."""
    out = torch.zeros((m, b.shape[1]), dtype=torch.float32, device=b.device)
    for lo in range(0, rows.shape[0], block):
        r, c, v = rows[lo:lo + block], cols[lo:lo + block], vals[lo:lo + block]
        out.index_add_(0, r, b.index_select(0, c) * v[:, None])
    return out


@torch.no_grad()
def gcn_logits(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, n: int,
               x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Logits ``[n, classes]`` of one request ``x [n, features]``."""
    h = x
    for i, w in enumerate(weights):
        h = spmm(rows, cols, vals, n, dense(h, w))
        if i < len(weights) - 1:
            h = torch.relu(h)
    return h


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """``max|got - ref| / max|ref|``; infinite for a wrong shape or a
    non-finite value."""
    if got.shape != ref.shape:
        return float("inf")
    diff = (got.to(ref.device, torch.float32) - ref).abs().max()
    if not torch.isfinite(diff):
        return float("inf")
    return float(diff / ref.abs().max().clamp_min(torch.finfo(torch.float32).tiny))
