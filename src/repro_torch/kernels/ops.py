"""Public SpMM and attention entry points with a backend switch.

``"cuda"`` runs the hand-written kernel and is the default for a CUDA
tensor; ``"torch"`` runs plain PyTorch and is the default for a CPU tensor.
"""

from __future__ import annotations

import torch

from repro_torch.core import csc as fmt
from repro_torch.core import spmm as spmm_ref_mod
from repro_torch.core.schedule import Schedule
from repro_torch.kernels import flash_attention_cuda as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import spmm_cuda as _sp

BACKENDS = ("cuda", "torch")
#: the JAX package's SpMM routings (``repro.kernels.ops.spmm``)
ROUTINGS = ("auto", "gather", "onehot")


def default_backend(b: torch.Tensor) -> str:
    return "cuda" if b.is_cuda else "torch"


# ---------------------------------------------------------------------------
# SpMM
# ---------------------------------------------------------------------------


def spmm(sched: Schedule, b: torch.Tensor, *, backend: str | None = None,
         ktile: int = 128, routing: str = "auto") -> torch.Tensor:
    """C = A @ B through the converged AWB schedule.

    ``routing`` keeps the JAX signature and is validated as there
    (``"auto"``, ``"gather"`` or ``"onehot"``). The kernel has one routing,
    so on the card every value runs the same kernel, and the plain version
    likewise."""
    if routing not in ROUTINGS:
        raise ValueError(f"unknown routing {routing!r}; expected one of {ROUTINGS}")
    backend = backend or default_backend(b)
    if backend == "cuda":
        return _sp.spmm_balanced(sched, b, ktile=ktile)
    if backend == "torch":
        return _sp.spmm_balanced_plain(sched, b)
    raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")


def spmm_coo(a: fmt.COO, b: torch.Tensor) -> torch.Tensor:
    """Schedule-free reference path."""
    return spmm_ref_mod.spmm_coo(a, b)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              scale: float | None = None, backend: str | None = None,
              block_q: int = 128, block_k: int = 128,
              chunk: int | None = None) -> torch.Tensor:
    """Multi-head attention, q [B,Sq,H,D], kv [B,Sk,Hkv,D] (GQA).

    ``"cuda"`` runs the flash kernel (``chunk`` is ignored there, as the
    JAX package ignores it on the TPU path). ``"torch"`` runs, on the CPU,
    the chunked oracle when ``chunk`` is given and ``attention_ref``
    otherwise; on a CUDA tensor it runs the kernel's plain version.
    ``block_q``/``block_k`` keep the JAX signature: the kernel's tiles are
    fixed when it is compiled. Meta tensors (the dry-run) take the card's
    path by default, through the kernel's operator's meta version."""
    backend = backend or ("cuda" if q.is_meta else default_backend(q))
    if backend == "cuda":
        if not (q.is_cuda or q.is_meta):
            raise ValueError(f"backend 'cuda' needs CUDA tensors; q is on {q.device}")
        return _fa.flash_attention(q, k, v, causal=causal, window=window, scale=scale)
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if q.is_cuda:
        return _fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                         scale=scale)
    if chunk is not None:
        return _ref.attention_chunked(q, k, v, causal=causal, window=window,
                                      scale=scale, block_k=chunk)
    return _ref.attention_ref(q, k, v, causal=causal, window=window, scale=scale)
