"""Parity of the port's sparse formats with ``repro.core.csc``: identical
index and value arrays for identical numpy input."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import csc as jfmt  # noqa: E402
from repro_torch.core import csc as tfmt  # noqa: E402


def _dense(n=40, m=None, density=0.1, seed=0):
    rng = np.random.default_rng(seed)
    m = m or n
    a = rng.standard_normal((m, n)).astype(np.float32)
    return a * (rng.random((m, n)) < density)


def _eq(t, j):
    assert np.array_equal(tfmt.to_numpy(t), np.asarray(j))


def _eq_coo(t, j):
    _eq(t.row, j.row)
    _eq(t.col, j.col)
    _eq(t.val, j.val)
    assert tuple(t.shape) == tuple(j.shape)


@pytest.mark.parametrize("seed", [0, 1])
def test_coo_from_dense_and_arrays(seed):
    a = _dense(37, 29, 0.15, seed)
    _eq_coo(tfmt.coo_from_dense(a), jfmt.coo_from_dense(a))
    rng = np.random.default_rng(seed)
    row = rng.integers(0, 50, 200)
    col = rng.integers(0, 60, 200)
    val = rng.standard_normal(200).astype(np.float32)
    t = tfmt.coo_from_arrays(row, col, val, (50, 60))
    _eq_coo(t, jfmt.coo_from_arrays(row, col, val, (50, 60)))
    assert t.row.dtype == torch.int32 and t.val.dtype == torch.float32


def test_csr_csc_ell_and_dense_roundtrips():
    a = _dense(33, 41, 0.2, 3)
    tc, jc = tfmt.coo_from_dense(a), jfmt.coo_from_dense(a)
    for t, j in ((tfmt.csr_from_coo(tc), jfmt.csr_from_coo(jc)),
                 (tfmt.csc_from_coo(tc), jfmt.csc_from_coo(jc))):
        _eq(t.indptr, j.indptr)
        _eq(t.indices, j.indices)
        _eq(t.data, j.data)
    np.testing.assert_array_equal(tfmt.to_numpy(tfmt.coo_to_dense(tc)), a)
    csr = tfmt.csr_from_dense(a)
    csc = tfmt.csc_from_dense(a)
    np.testing.assert_array_equal(tfmt.to_numpy(tfmt.csr_to_dense(csr)), a)
    np.testing.assert_array_equal(tfmt.to_numpy(tfmt.csc_to_dense(csc)), a)
    te, je = tfmt.ell_from_dense(a), jfmt.ell_from_dense(a)
    _eq(te.indices, je.indices)
    _eq(te.data, je.data)
    np.testing.assert_array_equal(tfmt.to_numpy(tfmt.ell_to_dense(te)), a)
    _eq_coo(tfmt.csc_to_coo(tfmt.csc_from_coo(tc)),
            jfmt.csc_to_coo(jfmt.csc_from_coo(jc)))
    _eq_coo(tfmt.csr_to_coo(tfmt.csr_from_coo(tc)),
            jfmt.csr_to_coo(jfmt.csr_from_coo(jc)))


def test_transpose_permute_pad_and_counts():
    a = _dense(30, 30, 0.12, 5)
    tc, jc = tfmt.coo_from_dense(a), jfmt.coo_from_dense(a)
    _eq_coo(tfmt.transpose_coo(tc), jfmt.transpose_coo(jc))
    perm = np.random.default_rng(5).permutation(30)
    _eq_coo(tfmt.permute_coo(tc, perm), jfmt.permute_coo(jc, perm))
    tp = tfmt.permute_csc(tfmt.csc_from_coo(tc), perm)
    jp = jfmt.permute_csc(jfmt.csc_from_coo(jc), perm)
    _eq(tp.indptr, jp.indptr)
    _eq(tp.indices, jp.indices)
    tpad, jpad = tfmt.pad_coo(tc, tc.nnz + 7), jfmt.pad_coo(jc, jc.nnz + 7)
    _eq_coo(tpad, jpad)
    _eq(tfmt.row_nnz(tpad), jfmt.row_nnz(jpad))
    _eq(tfmt.col_nnz(tpad), jfmt.col_nnz(jpad))
    # padding is inert in every consumer
    _eq_coo(tfmt.transpose_coo(tpad), jfmt.transpose_coo(jpad))
    np.testing.assert_array_equal(tfmt.to_numpy(tfmt.coo_to_dense(tpad)), a)
    with pytest.raises(ValueError):
        tfmt.pad_coo(tc, tc.nnz - 1)
    with pytest.raises(ValueError):
        tfmt.permute_coo(tc, np.zeros(30, np.int64))


@pytest.mark.parametrize("kind", ["mixed", "values_only", "empty"])
def test_apply_edge_delta_matches_reference(kind):
    a = _dense(25, 25, 0.15, 7)
    tc, jc = tfmt.coo_from_dense(a), jfmt.coo_from_dense(a)
    r, c = np.nonzero(a)
    if kind == "mixed":  # insert, overwrite, delete, duplicate (last wins)
        delta = (np.array([0, r[0], r[1], 3, 3]), np.array([0, c[0], c[1], 4, 4]),
                 np.array([1.5, 2.5, 0.0, 1.0, -2.0], np.float32))
    elif kind == "values_only":
        delta = (r[:4], c[:4], np.array([9.0, 8.0, 7.0, 6.0], np.float32))
    else:
        delta = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.float32))
    tout, trep = tfmt.apply_edge_delta(tc, tfmt.EdgeDelta(*delta), with_report=True)
    jout, jrep = jfmt.apply_edge_delta(jc, jfmt.EdgeDelta(*delta), with_report=True)
    _eq_coo(tout, jout)
    for f in trep._fields:
        assert np.array_equal(np.asarray(getattr(trep, f)),
                              np.asarray(getattr(jrep, f)))
    _eq_coo(tfmt.apply_edge_delta(tc, tfmt.EdgeDelta(*delta)), jout)


def test_apply_edge_delta_rejects_bad_input():
    tc = tfmt.coo_from_dense(_dense(10, 10, 0.3, 1))
    with pytest.raises(ValueError):
        tfmt.apply_edge_delta(tc, tfmt.EdgeDelta(np.array([10]), np.array([0]),
                                                 np.array([1.0])))
    with pytest.raises(ValueError):
        tfmt.apply_edge_delta(tc, tfmt.EdgeDelta(np.array([1, 2]), np.array([0]),
                                                 np.array([1.0])))
