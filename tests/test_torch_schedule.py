"""Parity of the port's schedules with ``repro.core.schedule``: the six
schedule arrays are bit-identical across builder geometries, repairs and
serialization; the tensor executor and epilogue agree with the jnp ones."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import csc as jfmt  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import spmm as jspmm  # noqa: E402
from repro.graphs import synth as jsynth  # noqa: E402
from repro_torch.core import csc as tfmt  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core import spmm as tspmm  # noqa: E402
from repro_torch.graphs import synth as tsynth  # noqa: E402

FIELDS = ("win_id", "col_block", "val", "local_row", "local_col", "row_map")


def _same(ts, js):
    for f in FIELDS:
        assert np.array_equal(getattr(ts, f), getattr(js, f)), f
    for f in ("shape", "nnz_per_step", "rows_per_window", "cols_per_block", "nnz",
              "n_evil_chunks"):
        assert getattr(ts, f) == getattr(js, f), f


def _pair(n=300, density=0.03, alpha=0.9, seed=7):
    return (tsynth.power_law_adjacency(n, density, alpha, seed=seed),
            jsynth.power_law_adjacency(n, density, alpha, seed=seed))


@pytest.mark.parametrize("k,r,cb,evil", [
    (256, 64, None, None), (32, 16, None, None), (16, 8, 32, 8), (32, 16, "auto", None),
    (8, 4, None, 4), (64, 8, 100, 16)])
def test_balanced_builder_matches_reference(k, r, cb, evil):
    ta, ja = _pair(400, 0.04, 1.1, seed=k + r)
    kw = dict(cols_per_block=cb, evil_threshold=evil)
    ts = tsched.build_balanced_schedule(ta, k, r, **kw)
    js = jsched.build_balanced_schedule(ja, k, r, **kw)
    _same(ts, js)
    assert ts.utilization == js.utilization


@pytest.mark.parametrize("k,r,cb", [(16, 8, None), (32, 16, 64)])
def test_naive_builder_matches_reference(k, r, cb):
    ta, ja = _pair(150, 0.04, 1.0, seed=9)
    _same(tsched.build_naive_schedule(ta, k, r, cols_per_block=cb),
          jsched.build_naive_schedule(ja, k, r, cols_per_block=cb))


def test_padded_coo_builds_the_same_schedule():
    ta, ja = _pair(120, 0.05, 0.8, seed=2)
    _same(tsched.build_balanced_schedule(tfmt.pad_coo(ta, ta.nnz + 9), 16, 8),
          jsched.build_balanced_schedule(jfmt.pad_coo(ja, ja.nnz + 9), 16, 8))


def test_serialization_roundtrip_and_validation():
    ta, ja = _pair()
    ts = tsched.build_balanced_schedule(ta, 32, 16, evil_threshold=8)
    js = jsched.build_balanced_schedule(ja, 32, 16, evil_threshold=8)
    tarr, jarr = tsched.schedule_to_arrays(ts), jsched.schedule_to_arrays(js)
    assert tarr.keys() == jarr.keys()
    for key in tarr:
        assert np.array_equal(tarr[key], jarr[key])
    _same(tsched.schedule_from_arrays(jarr), js)
    assert tsched.SCHEDULE_FORMAT_VERSION == jsched.SCHEDULE_FORMAT_VERSION
    assert tsched.SCHEDULE_BUILDER_VERSION == jsched.SCHEDULE_BUILDER_VERSION
    bad = dict(tarr, local_row=tarr["local_row"] + 100)
    with pytest.raises(ValueError):
        tsched.schedule_from_arrays(bad)


@pytest.mark.parametrize("evil", [None, 8])
def test_repair_matches_reference(evil):
    ta, ja = _pair(300, 0.03, 0.9, seed=11)
    kw = dict(nnz_per_step=32, rows_per_window=16, evil_threshold=evil)
    ts = tsched.build_balanced_schedule(ta, 32, 16, evil_threshold=evil)
    js = jsched.build_balanced_schedule(ja, 32, 16, evil_threshold=evil)
    rng = np.random.default_rng(11)
    rows = rng.integers(0, 300, 12)
    cols = rng.integers(0, 300, 12)
    vals = np.where(rng.random(12) < 0.2, 0.0, rng.random(12)).astype(np.float32)
    tnew = tfmt.apply_edge_delta(ta, tfmt.EdgeDelta(rows, cols, vals))
    jnew = jfmt.apply_edge_delta(ja, jfmt.EdgeDelta(rows, cols, vals))
    trep, tstats = tsched.repair_schedule(ts, ta, tnew, rows, **kw)
    jrep, jstats = jsched.repair_schedule(js, ja, jnew, rows, **kw)
    _same(trep, jrep)
    _same(trep, tsched.build_balanced_schedule(tnew, 32, 16, evil_threshold=evil))
    for f in dataclasses.fields(tstats):
        tv, jv = getattr(tstats, f.name), getattr(jstats, f.name)
        assert np.array_equal(np.asarray(tv), np.asarray(jv)), f.name


def test_value_patch_matches_reference():
    ta, ja = _pair(200, 0.04, 0.9, seed=5)
    ts = tsched.build_balanced_schedule(ta, 16, 8)
    js = jsched.build_balanced_schedule(ja, 16, 8)
    tkeys, jkeys = tsched.slot_entry_keys(ts), jsched.slot_entry_keys(js)
    assert np.array_equal(tkeys[0], jkeys[0]) and np.array_equal(tkeys[1], jkeys[1])
    rows, cols = tfmt.to_numpy(ta.row)[:5], tfmt.to_numpy(ta.col)[:5]
    vals = np.arange(1, 6, dtype=np.float32)
    tp, tslots = tsched.value_patch_schedule(ts, tkeys, rows, cols, vals)
    jp, jslots = jsched.value_patch_schedule(js, jkeys, rows, cols, vals)
    _same(tp, jp)
    assert np.array_equal(tslots, jslots)
    zr, zc = np.argwhere(tfmt.to_numpy(tfmt.coo_to_dense(ta)) == 0)[0]
    assert tsched.value_patch_schedule(ts, tkeys, [zr], [zc], [1.0]) is None
    assert jsched.value_patch_schedule(js, jkeys, [zr], [zc], [1.0]) is None


@pytest.mark.parametrize("builder,kw", [
    (tsched.build_balanced_schedule, dict(nnz_per_step=32, rows_per_window=16)),
    (tsched.build_balanced_schedule, dict(nnz_per_step=16, rows_per_window=8,
                                          cols_per_block=32, evil_threshold=8)),
    (tsched.build_naive_schedule, dict(nnz_per_step=16, rows_per_window=8))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_execute_schedule_torch_matches_jnp(builder, kw, dtype):
    ta, ja = _pair(96, 0.1, 1.2, seed=4)
    ts = builder(ta, **kw)
    js = getattr(jsched, builder.__name__)(ja, **kw)
    b = np.random.default_rng(4).standard_normal((96, 9)).astype(np.float32)
    jb = jnp.asarray(b).astype(dtype)
    tb = torch.from_numpy(b).to(getattr(torch, dtype))
    want = np.asarray(jsched.execute_schedule_jnp(js, jb).astype(jnp.float32))
    got = tsched.execute_schedule_torch(ts, tb).float().numpy()
    gold = np.asarray(jspmm.spmm_coo(ja, jnp.asarray(b)))
    tol = (1e-4 if dtype == "float32" else 3e-2) * max(1.0, np.abs(gold).max())
    np.testing.assert_allclose(got, want, atol=tol)
    np.testing.assert_allclose(got, gold, atol=tol)
    assert tspmm.spmm_coo(ta, tb).dtype == tb.dtype


def test_scatter_epilogue_matches_reference():
    ta, ja = _pair(96, 0.1, 1.2, seed=4)
    ts = tsched.build_balanced_schedule(ta, 16, 8, evil_threshold=8)
    js = jsched.build_balanced_schedule(ja, 16, 8, evil_threshold=8)
    assert ts.n_evil_chunks > 0
    out_perm = np.random.default_rng(0).standard_normal(
        (ts.n_windows * 8, 5)).astype(np.float32)
    got = tsched.scatter_epilogue(ts, torch.from_numpy(out_perm)).numpy()
    want = np.asarray(jsched.scatter_epilogue(js, jnp.asarray(out_perm)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_auto_cols_per_block_matches_reference():
    for n in (100, 256, 257, 10_000):
        assert tsched.auto_cols_per_block(n) == jsched.auto_cols_per_block(n)
