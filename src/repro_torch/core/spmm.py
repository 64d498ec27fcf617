"""Column-wise-product SpMM (the paper's §III.B execution order) on tensors.

The counterpart of ``repro.core.spmm``. Given sparse S (m×n) and dense B
(n×k), ``C = S @ B``: every non-zero (r, c, v) of S contributes
``v * B[c, :]`` to row r of C — a gather of B rows by column index, then an
``index_add_`` over row indices. These are the plain reference versions
(oracles for the SpMM kernel); they run on ``b``'s device.
"""

from __future__ import annotations

import torch

from repro_torch.core import csc as fmt

#: elements of the ``[chunk, k]`` gather intermediate ``spmm_coo`` allows
#: at once (256 MiB of f32): a full-size graph's unchunked intermediate is
#: tens of GB.
GATHER_ELEMS = 1 << 26


def spmm_coo(a: fmt.COO, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B via column-wise product. Handles PAD_IDX entries. Walks
    the non-zeros in chunks so the gathered rows stay bounded."""
    m, _ = a.shape
    kdim = b.shape[1]
    dev = b.device
    row = a.row.to(dev)
    col = a.col.to(dev)
    val = a.val.to(dev)
    out = b.new_zeros((m, kdim))
    chunk = max(1, GATHER_ELEMS // max(1, kdim))
    for lo in range(0, row.shape[0], chunk):
        r, c, v = row[lo : lo + chunk], col[lo : lo + chunk], val[lo : lo + chunk]
        valid = r != fmt.PAD_IDX
        v = torch.where(valid, v, 0).to(b.dtype)
        gathered = b[torch.where(valid, c, 0).long()] * v[:, None]
        out.index_add_(0, torch.where(valid, r, 0).long(), gathered)
    return out


def spmm_csc(a: fmt.CSC, b: torch.Tensor) -> torch.Tensor:
    return spmm_coo(fmt.csc_to_coo(a), b)


def spmm_dense(a_dense: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """TDQ-1 path: X·W as a dense product (``torch.matmul``)."""
    return a_dense @ b


def spmm_coo_blocked(a: fmt.COO, b: torch.Tensor, t: int = 4) -> torch.Tensor:
    """Matrix-blocking variant (paper Fig. 9): process B in t-column panels
    so each block of A is reused t times before eviction. Numerically
    identical to ``spmm_coo``."""
    k = b.shape[1]
    panels = [spmm_coo(a, b[:, j : j + t]) for j in range(0, k, t)]
    return torch.cat(panels, dim=1) if panels else spmm_coo(a, b)


def gcn_layer_ref(a: fmt.COO, x: torch.Tensor, w: torch.Tensor,
                  activation=torch.relu) -> torch.Tensor:
    """σ(A·(X·W)) with the paper's A×(X×W) ordering (§III.A, Table II)."""
    axw = spmm_coo(a, spmm_dense(x, w))
    return activation(axw) if activation is not None else axw


def flops_axw_orders(a_nnz: int, x_shape, w_shape, x_density: float = 1.0):
    """Operation counts for (A×X)×W vs A×(X×W) — reproduces Table II.

    Counts multiply ops on non-zeros only (the paper counts 'operations').
    """
    n_nodes, n_feat = x_shape
    _, n_hid = w_shape
    ax = a_nnz * n_feat
    axw = n_nodes * n_feat * n_hid
    order1 = ax + axw
    xw = int(n_nodes * n_feat * x_density) * n_hid
    a_xw = a_nnz * n_hid
    order2 = xw + a_xw
    return order1, order2
