"""Sparse matrix formats for AWB-GCN, as NamedTuples of torch tensors.

The counterpart of ``repro.core.csc``. Construction and conversion between
formats is host-side numpy, so the index and value arrays are bit-identical
to the JAX package's for the same input; the results are CPU tensors.
The conversions back to dense run on whatever device the tensors live on.

Conventions
-----------
* All index arrays are int32.
* Padding entries use column/row index ``PAD_IDX == -1`` and value 0.0 so a
  padded SpMM contributes nothing.
* ``nnz`` is the *padded* nnz capacity.
* Float64 values are stored as float32, as ``jnp.asarray`` does with 64-bit
  mode off.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

PAD_IDX = -1


def to_numpy(x) -> np.ndarray:
    """Host numpy view of a tensor or array-like (copies off the device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _idx(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))


def _val(x) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype == np.float64:
        x = x.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(x))


class COO(NamedTuple):
    """Coordinate format, row-major sorted unless stated otherwise."""

    row: torch.Tensor  # [nnz] int32
    col: torch.Tensor  # [nnz] int32
    val: torch.Tensor  # [nnz] float
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.row.shape[0]


class CSR(NamedTuple):
    indptr: torch.Tensor  # [m+1] int32
    indices: torch.Tensor  # [nnz] int32 column ids
    data: torch.Tensor  # [nnz]
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.indices.shape[0]


class CSC(NamedTuple):
    """The paper's format for A: non-zeros contiguous per column."""

    indptr: torch.Tensor  # [n+1] int32
    indices: torch.Tensor  # [nnz] int32 row ids
    data: torch.Tensor  # [nnz]
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.indices.shape[0]


class ELL(NamedTuple):
    """ELLPACK: fixed non-zeros per row, padded. Used by dense-ish operands."""

    indices: torch.Tensor  # [m, k] int32 column ids, PAD_IDX for padding
    data: torch.Tensor  # [m, k]
    shape: Tuple[int, int]


# ---------------------------------------------------------------------------
# Construction from dense / scipy-style triplets (host-side, numpy)
# ---------------------------------------------------------------------------


def coo_from_dense(a: np.ndarray) -> COO:
    r, c = np.nonzero(a)
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    return COO(_idx(r), _idx(c), _val(a[r, c]), a.shape)


def coo_from_arrays(
    row: np.ndarray, col: np.ndarray, val: np.ndarray, shape: Tuple[int, int]
) -> COO:
    order = np.lexsort((col, row))
    return COO(_idx(row[order]), _idx(col[order]), _val(val[order]), shape)


class EdgeDelta(NamedTuple):
    """A batch of edge mutations against a row-major COO.

    Each ``(row, col, val)`` triple is an *upsert*: the edge is inserted if
    absent, its value replaced if present — except ``val == 0.0``, which
    removes the edge (removing an absent edge is a no-op). Duplicate
    coordinates within one delta resolve last-write-wins.
    """

    row: np.ndarray  # [d] int
    col: np.ndarray  # [d] int
    val: np.ndarray  # [d] float

    @property
    def n_edges(self) -> int:
        return int(np.asarray(self.row).shape[0])


class DeltaReport(NamedTuple):
    """Bookkeeping from ``apply_edge_delta``: which rows changed and by how
    many non-zeros."""

    touched_rows: np.ndarray  # sorted unique rows named by the delta
    row_nnz_delta: np.ndarray  # per touched row, nnz(new) - nnz(old)
    n_added: int
    n_removed: int
    n_updated: int  # value-only overwrites of existing edges


def apply_edge_delta(a: COO, delta: EdgeDelta, *, with_report: bool = False):
    """Apply ``delta`` to a row-major-sorted COO; returns a host (CPU
    tensor) row-major COO — or ``(coo, DeltaReport)`` when ``with_report``
    is set. Same merge as the JAX package: dedupe and key-sort the delta,
    mask overwritten/removed base entries by a searchsorted probe, insert
    at searchsorted positions — ``O(nnz)`` memcpy, never a full lexsort."""
    m, n = a.shape
    row = to_numpy(a.row)
    keep = row != PAD_IDX
    col = to_numpy(a.col)
    val = to_numpy(a.val)
    if not keep.all():
        row, col, val = row[keep], col[keep], val[keep]
    drow = np.atleast_1d(np.asarray(delta.row, np.int64))
    dcol = np.atleast_1d(np.asarray(delta.col, np.int64))
    dval = np.atleast_1d(np.asarray(delta.val, val.dtype if val.size else np.float32))
    if not (drow.shape == dcol.shape == dval.shape):
        raise ValueError("EdgeDelta row/col/val shapes differ")
    if drow.size == 0:
        out = COO(_idx(row), _idx(col), _val(val), a.shape)
        if with_report:
            z = np.zeros(0, np.int64)
            return out, DeltaReport(z, z.copy(), 0, 0, 0)
        return out
    if drow.min() < 0 or drow.max() >= m or dcol.min() < 0 or dcol.max() >= n:
        raise ValueError(f"EdgeDelta indices out of bounds for shape {a.shape}")
    touched = np.unique(drow)
    dkey = drow * n + dcol
    order = np.argsort(dkey, kind="stable")
    dkey, dval = dkey[order], dval[order]
    last = np.concatenate([dkey[1:] != dkey[:-1], [True]])  # last write wins
    dkey, dval = dkey[last], dval[last]
    key = row.astype(np.int64) * n + col
    # base entries whose coordinate the delta overwrites or removes
    pos = np.searchsorted(dkey, key)
    pos = np.minimum(pos, dkey.size - 1)
    survive = dkey[pos] != key
    # delta coordinates already present in the base
    bpos = np.minimum(np.searchsorted(key, dkey), max(key.size - 1, 0))
    existed = key[bpos] == dkey if key.size else np.zeros(dkey.size, bool)
    ins = dval != 0.0
    if not np.any(ins & ~existed) and not np.any(existed & ~ins):
        # pure value update: share the structure, overwrite values
        upd = ins
        val2 = val.copy()
        val2[bpos[upd]] = dval[upd]
        out = COO(_idx(row), _idx(col), _val(val2), a.shape)
        if not with_report:
            return out
        report = DeltaReport(
            touched_rows=touched,
            row_nnz_delta=np.zeros(touched.size, np.int64),
            n_added=0,
            n_removed=0,
            n_updated=int(np.count_nonzero(upd)),
        )
        return out, report
    skey = key[survive]
    ikey = dkey[ins]
    mpos = np.searchsorted(skey, ikey)
    out = COO(
        _idx(np.insert(row[survive], mpos, (ikey // n))),
        _idx(np.insert(col[survive], mpos, (ikey % n))),
        _val(np.insert(val[survive], mpos, dval[ins])),
        a.shape,
    )
    if not with_report:
        return out
    change = (ins & ~existed).astype(np.int64) - (~ins & existed)
    per_row = np.zeros(touched.size, np.int64)
    np.add.at(per_row, np.searchsorted(touched, dkey // n), change)
    report = DeltaReport(
        touched_rows=touched,
        row_nnz_delta=per_row,
        n_added=int(np.count_nonzero(ins & ~existed)),
        n_removed=int(np.count_nonzero(~ins & existed)),
        n_updated=int(np.count_nonzero(ins & existed)),
    )
    return out, report


def transpose_coo(a: COO) -> COO:
    """Aᵀ as a fresh row-major-sorted COO (padding entries dropped)."""
    row = to_numpy(a.col)
    col = to_numpy(a.row)
    val = to_numpy(a.val)
    keep = col != PAD_IDX
    return coo_from_arrays(row[keep], col[keep], val[keep], (a.shape[1], a.shape[0]))


def permute_coo(a: COO, perm: np.ndarray) -> COO:
    """``P·A`` as a fresh row-major-sorted host COO: row ``i`` of the result
    is row ``perm[i]`` of ``a`` (``perm[new] = old``, the ``core.reorder``
    convention; padding entries are dropped). Only rows move."""
    m, _ = a.shape
    perm = np.asarray(perm, np.int64)
    if perm.shape[0] != m:
        raise ValueError(f"permutation has {perm.shape[0]} entries; A has {m} rows")
    inv = np.full(m, -1, np.int64)
    inv[perm] = np.arange(m, dtype=np.int64)
    if (inv < 0).any():
        raise ValueError("not a permutation: duplicate/missing indices")
    row = to_numpy(a.row)
    col = to_numpy(a.col)
    val = to_numpy(a.val)
    keep = row != PAD_IDX
    if not keep.all():
        row, col, val = row[keep], col[keep], val[keep]
    return coo_from_arrays(inv[row.astype(np.int64)], col, val, a.shape)


def permute_csc(a: CSC, perm: np.ndarray) -> CSC:
    """``P·A`` in CSC (same ``perm[new] = old`` convention as
    ``permute_coo``)."""
    return csc_from_coo(permute_coo(csc_to_coo(a), perm))


def _ptr_from_sorted(ids: np.ndarray, dim: int) -> np.ndarray:
    counts = np.bincount(ids, minlength=dim)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def csr_from_coo(a: COO) -> CSR:
    row = to_numpy(a.row)
    col = to_numpy(a.col)
    val = to_numpy(a.val)
    order = np.lexsort((col, row))
    return CSR(
        torch.from_numpy(_ptr_from_sorted(row[order], a.shape[0])),
        _idx(col[order]),
        _val(val[order]),
        a.shape,
    )


def csc_from_coo(a: COO) -> CSC:
    row = to_numpy(a.row)
    col = to_numpy(a.col)
    val = to_numpy(a.val)
    order = np.lexsort((row, col))
    return CSC(
        torch.from_numpy(_ptr_from_sorted(col[order], a.shape[1])),
        _idx(row[order]),
        _val(val[order]),
        a.shape,
    )


def csc_from_dense(a: np.ndarray) -> CSC:
    return csc_from_coo(coo_from_dense(a))


def csr_from_dense(a: np.ndarray) -> CSR:
    return csr_from_coo(coo_from_dense(a))


def ell_from_dense(a: np.ndarray, width: int | None = None) -> ELL:
    m, _ = a.shape
    per_row = (a != 0).sum(axis=1)
    k = int(per_row.max()) if width is None else width
    idx = np.full((m, k), PAD_IDX, np.int32)
    dat = np.zeros((m, k), a.dtype)
    for i in range(m):
        cols = np.nonzero(a[i])[0][:k]
        idx[i, : len(cols)] = cols
        dat[i, : len(cols)] = a[i, cols]
    return ELL(_idx(idx), _val(dat), a.shape)


# ---------------------------------------------------------------------------
# Conversions back to dense (on the tensors' device; used by oracles/tests)
# ---------------------------------------------------------------------------


def _scatter_dense(r, c, v, valid, shape) -> torch.Tensor:
    out = torch.zeros(shape, dtype=v.dtype, device=v.device)
    r = torch.where(valid, r, 0).long()
    c = torch.where(valid, c, 0).long()
    v = torch.where(valid, v, torch.zeros((), dtype=v.dtype, device=v.device))
    return out.index_put_((r, c), v, accumulate=True)


def coo_to_dense(a: COO) -> torch.Tensor:
    return _scatter_dense(a.row, a.col, a.val, a.row != PAD_IDX, a.shape)


def csr_to_coo(a: CSR) -> COO:
    m, _ = a.shape
    counts = np.diff(to_numpy(a.indptr))
    row = _idx(np.repeat(np.arange(m, dtype=np.int32), counts))
    return COO(row.to(a.indices.device), a.indices, a.data, a.shape)


def csc_to_coo(a: CSC) -> COO:
    _, n = a.shape
    counts = np.diff(to_numpy(a.indptr))
    col = _idx(np.repeat(np.arange(n, dtype=np.int32), counts))
    return COO(a.indices, col.to(a.indices.device), a.data, a.shape)


def csc_to_dense(a: CSC) -> torch.Tensor:
    return coo_to_dense(csc_to_coo(a))


def csr_to_dense(a: CSR) -> torch.Tensor:
    return coo_to_dense(csr_to_coo(a))


def ell_to_dense(a: ELL) -> torch.Tensor:
    m, _ = a.shape
    r = torch.arange(m, dtype=torch.int32, device=a.indices.device)[:, None]
    r = r.expand(a.indices.shape)
    return _scatter_dense(r, a.indices, a.data, a.indices != PAD_IDX, a.shape)


# ---------------------------------------------------------------------------
# Padding and per-row / per-column counts
# ---------------------------------------------------------------------------


def pad_coo(a: COO, capacity: int) -> COO:
    """Pad nnz up to `capacity` with inert entries."""
    nnz = a.nnz
    if capacity < nnz:
        raise ValueError(f"capacity {capacity} < nnz {nnz}")
    pad = capacity - nnz
    fill = torch.full((pad,), PAD_IDX, dtype=torch.int32, device=a.row.device)
    return COO(
        torch.cat([a.row, fill]),
        torch.cat([a.col, fill]),
        torch.cat([a.val, a.val.new_zeros(pad)]),
        a.shape,
    )


def _count(ids: torch.Tensor, dim: int) -> torch.Tensor:
    valid = ids != PAD_IDX
    out = torch.zeros(dim, dtype=torch.int32, device=ids.device)
    return out.index_add_(0, torch.where(valid, ids, 0).long(), valid.int())


def row_nnz(a: COO, num_rows: int | None = None) -> torch.Tensor:
    """Non-zeros per row (the workload histogram the paper's profiler tracks)."""
    return _count(a.row, a.shape[0] if num_rows is None else num_rows)


def col_nnz(a: COO, num_cols: int | None = None) -> torch.Tensor:
    return _count(a.col, a.shape[1] if num_cols is None else num_cols)
