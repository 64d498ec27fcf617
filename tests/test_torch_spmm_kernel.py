"""The port's SpMM kernel module against the JAX package's Pallas kernel and
oracles. On the CPU ``spmm_cuda``'s wrappers run their plain versions; the
kernels themselves are held against those on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import schedule as jsched  # noqa: E402
from repro.core import spmm as jspmm  # noqa: E402
from repro.graphs import synth as jsynth  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import spmm_pallas  # noqa: E402
from repro_torch.core import csc as tfmt  # noqa: E402
from repro_torch.core import executor as texe  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core import spmm as tspmm  # noqa: E402
from repro_torch.graphs import synth as tsynth  # noqa: E402
from repro_torch.kernels import ops, ref, spmm_cuda  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _case(n, density, alpha, kdim, seed):
    ta = tsynth.power_law_adjacency(n, density, alpha, seed=seed)
    ja = jsynth.power_law_adjacency(n, density, alpha, seed=seed)
    b = np.random.default_rng(seed).standard_normal((n, kdim)).astype(np.float32)
    return ta, ja, b


def _check(got, gold, dtype):
    atol = TOL[dtype] * max(1.0, np.abs(gold).max())
    np.testing.assert_allclose(got, gold, atol=atol)


@pytest.mark.parametrize("n,density,alpha,kdim,dtype", [
    (64, 0.05, 0.8, 5, "float32"), (123, 0.08, 0.6, 24, "bfloat16")])
def test_matches_pallas_kernel_in_interpret_mode(n, density, alpha, kdim, dtype):
    ta, ja, b = _case(n, density, alpha, kdim, n)
    js = jsched.build_balanced_schedule(ja, 32, 16)
    ts = tsched.build_balanced_schedule(ta, 32, 16)
    want = np.asarray(spmm_pallas.spmm_balanced(
        js, jnp.asarray(b).astype(dtype), ktile=8, interpret=True).astype(jnp.float32))
    got = spmm_cuda.spmm_balanced(ts, torch.from_numpy(b).to(getattr(torch, dtype)),
                                  ktile=8)
    assert got.dtype == getattr(torch, dtype)
    _check(got.float().numpy(), want, dtype)


def test_matches_pallas_kernel_blocked_with_evil_rows():
    ta, ja, b = _case(96, 0.1, 1.2, 9, 4)
    kw = dict(cols_per_block=32, evil_threshold=8)
    js = jsched.build_balanced_schedule(ja, 16, 8, **kw)
    ts = tsched.build_balanced_schedule(ta, 16, 8, **kw)
    assert ts.n_evil_chunks > 0
    want = np.asarray(spmm_pallas.spmm_balanced(js, jnp.asarray(b), ktile=8,
                                                interpret=True))
    _check(spmm_cuda.spmm_balanced(ts, torch.from_numpy(b), ktile=8).numpy(), want,
           "float32")


@pytest.mark.parametrize("n,density,alpha", [
    (64, 0.05, 0.8), (200, 0.02, 1.1), (123, 0.08, 0.6)])
@pytest.mark.parametrize("kdim", [5, 16, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sweep_against_reference_oracles(n, density, alpha, kdim, dtype):
    ta, ja, b = _case(n, density, alpha, kdim, n)
    gold = np.asarray(jspmm.spmm_coo(ja, jnp.asarray(b)))
    ts = tsched.build_balanced_schedule(ta, 32, 16)
    js = jsched.build_balanced_schedule(ja, 32, 16)
    tb = torch.from_numpy(b).to(getattr(torch, dtype))
    got = spmm_cuda.spmm_balanced(ts, tb, ktile=8).float().numpy()
    sched_ref = np.asarray(jref.spmm_schedule_ref(
        js, jnp.asarray(b).astype(dtype)).astype(jnp.float32))
    _check(got, gold, dtype)
    _check(got, sched_ref, dtype)
    _check(spmm_cuda.spmm_balanced_plain(ts, tb).float().numpy(), gold, dtype)


@pytest.mark.parametrize("builder", ["build_balanced_schedule", "build_naive_schedule"])
def test_both_schedules(builder):
    ta, ja, b = _case(150, 0.04, 1.0, 12, 9)
    ts = getattr(tsched, builder)(ta, 16, 8)
    gold = np.asarray(jspmm.spmm_coo(ja, jnp.asarray(b)))
    _check(spmm_cuda.spmm_balanced(ts, torch.from_numpy(b), ktile=8).numpy(), gold,
           "float32")


#: schedules whose output slots take sums from several steps, beside the
#: default one-step windows: (builder, kwargs)
SPANNING = {
    "balanced": ("build_balanced_schedule", {}),
    "blocked_evil": ("build_balanced_schedule",
                     dict(cols_per_block=32, evil_threshold=8)),
    "wide_windows": ("build_balanced_schedule", dict(window_nnz=64)),
    "naive": ("build_naive_schedule", {}),
}


def _spanning(kind, ta, ja=None):
    builder, kw = SPANNING[kind]
    ts = getattr(tsched, builder)(ta, 16, 8, **kw)
    js = None if ja is None else getattr(jsched, builder)(ja, 16, 8, **kw)
    return ts, js


@pytest.mark.parametrize("kind", sorted(SPANNING))
def test_kernel_plan_indexes_windows_and_live_slots(kind):
    ta, _, _ = _case(96, 0.1, 1.2, 1, 4)
    s, _ = _spanning(kind, ta)
    if kind == "blocked_evil":
        assert s.n_evil_chunks > 0
    plan = spmm_cuda.kernel_plan(s)
    k = s.nnz_per_step
    val = s.val.reshape(-1, k)
    lrow = s.local_row.reshape(-1, k)
    live, ptr = np.diff(plan["slot_ptr"]), plan["part_ptr"]
    assert live.shape == (s.n_steps,) and ptr.shape == (s.n_steps + 1,)
    slots = plan["slots"]
    assert slots.shape == (plan["slot_ptr"][-1], 2) and slots.dtype == np.int32
    n_parts = int(ptr[-1])
    part_row = np.empty(n_parts, np.int64)
    for step in range(s.n_steps):
        n_live = int(live[step])
        # padding is the step's tail; the live prefix ends on a non-zero
        assert np.all(val[step, n_live:] == 0)
        assert n_live == 0 or val[step, n_live - 1] != 0
        rows = lrow[step, :n_live]
        assert np.all(np.diff(rows) >= 0)  # runs of one row each
        runs = np.unique(rows)
        assert ptr[step + 1] - ptr[step] == runs.size
        # each live slot's record: its B row, a run flag, its value's bits
        rec = slots[plan["slot_ptr"][step]:plan["slot_ptr"][step + 1]]
        gcol = np.minimum(s.col_block[step] * s.cols_per_block
                          + s.local_col.reshape(-1, k)[step, :n_live], 95)
        assert np.array_equal(rec[:, 0] & 0x7FFFFFFF, gcol)
        flag = np.r_[True, rows[1:] != rows[:-1]][:n_live]
        assert np.array_equal(rec[:, 0] < 0, flag)
        assert np.array_equal(rec[:, 1].view(np.float32), val[step, :n_live])
        out_slots = s.win_id[step] * s.rows_per_window + runs
        part_row[ptr[step]:ptr[step + 1]] = s.row_map[out_slots]
    assert np.all(part_row >= 0)
    epi_ptr, epi_part = plan["epi_ptr"], plan["epi_part"]
    assert epi_ptr.shape == (s.shape[0] + 1,) and epi_ptr[-1] == epi_part.size
    assert np.array_equal(np.sort(epi_part), np.arange(n_parts))
    for row in range(s.shape[0]):
        parts = epi_part[epi_ptr[row]:epi_ptr[row + 1]]
        assert np.all(part_row[parts] == row) and np.all(np.diff(parts) > 0)
    # a partial never takes sums from two steps, so step order is free
    rev = tsched.Schedule(**{
        **s.__dict__, "win_id": s.win_id[::-1].copy(),
        "col_block": s.col_block[::-1].copy(),
        "val": val[::-1].reshape(-1).copy(), "local_row": lrow[::-1].reshape(-1).copy(),
        "local_col": s.local_col.reshape(-1, k)[::-1].reshape(-1).copy()})
    b = torch.from_numpy(np.random.default_rng(4).standard_normal((96, 6)).astype(
        np.float32))
    torch.testing.assert_close(spmm_cuda.spmm_balanced(rev, b),
                               spmm_cuda.spmm_balanced(s, b), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", sorted(SPANNING))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_path_matches_pallas_on_spanning_schedules(kind, dtype):
    ta, ja, b = _case(96, 0.1, 1.2, 11, 4)
    ts, js = _spanning(kind, ta, ja)
    for key in ("win_id", "col_block", "val", "local_row", "local_col", "row_map"):
        assert np.array_equal(getattr(ts, key), np.asarray(getattr(js, key)))
    jb = jnp.asarray(b).astype(dtype)
    want = np.asarray(spmm_pallas.spmm_balanced(js, jb, ktile=8, interpret=True)
                      .astype(jnp.float32))
    got = spmm_cuda.spmm_balanced(ts, torch.from_numpy(b).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    _check(got.float().numpy(), want, dtype)
    _check(got.float().numpy(), np.asarray(jspmm.spmm_coo(ja, jb.astype(
        jnp.float32))), dtype)


def test_padding_slots_gather_nothing():
    # no non-zero reads column 0, so only padding slots (lcol 0) point at it
    rng = np.random.default_rng(8)
    rows = np.repeat(np.arange(40), 3)
    cols = rng.integers(1, 40, rows.size)
    key = np.unique(rows * 40 + cols)
    a = tfmt.coo_from_arrays(key // 40, key % 40, np.ones(key.size, np.float32),
                             (40, 40))
    s = tsched.build_balanced_schedule(a, 16, 8)
    assert np.any(np.diff(spmm_cuda.kernel_plan(s)["slot_ptr"]) < 16)
    b = torch.ones((40, 5))
    b[0] = float("inf")
    got = spmm_cuda.spmm_balanced(s, b)
    assert torch.isfinite(got).all()
    b[0] = 1.0
    torch.testing.assert_close(got, tspmm.spmm_coo(a, b))


REDDIT_ROWS = 232_965


@pytest.mark.parametrize("kdim,dtype,rows,mapping,idle", [
    (512, torch.float32, REDDIT_ROWS, (4, 8, 1, 16), 0.0),
    (128, torch.float32, REDDIT_ROWS, (4, 8, 1, 4), 0.0),
    (164, torch.float32, REDDIT_ROWS, (4, 16, 3, 1), 7 / 48),
    (41, torch.float32, REDDIT_ROWS, (1, 16, 3, 1), 7 / 48),
    (512, torch.float32, 1000, (4, 32, 4, 1), 0.0),
    (128, torch.float32, 1000, (4, 32, 1, 1), 0.0),
    (512, torch.bfloat16, REDDIT_ROWS, (8, 8, 1, 8), 0.0),
    (512, torch.bfloat16, 1000, (8, 32, 2, 1), 0.0),
    (1024, torch.float32, 1000, (4, 32, 4, 2), 0.0),
])
def test_lane_mapping(kdim, dtype, rows, mapping, idle):
    assert spmm_cuda.lane_mapping(kdim, dtype, rows=rows) == mapping
    vec, gw, nc, panels = mapping
    assert 1 - kdim // vec / (panels * gw * nc) == pytest.approx(idle)
    vec, gw, nc, panels = spmm_cuda.lane_mapping(kdim, dtype, False, rows)
    assert vec == 1 and panels * gw * nc >= kdim
    assert gw in spmm_cuda.GROUP_WIDTHS and 1 <= nc <= spmm_cuda.MAX_VECTORS


@pytest.mark.parametrize("kdim,rows,mapping", [
    (128, REDDIT_ROWS, (8, 8, 2, 1)), (512, REDDIT_ROWS, (8, 8, 2, 4)),
    (256, REDDIT_ROWS, (8, 8, 2, 2)), (64, REDDIT_ROWS, (8, 8, 1, 1)),
    (512, 1000, (8, 32, 2, 1)), (164, REDDIT_ROWS, (1, 32, 3, 2)),
])
def test_bf16acc_wrapper_choices(kdim, rows, mapping):
    """The bf16-accumulate window's host-side choices, as plain functions:
    an f32 B is cast to bf16 once (a bf16 B and f32 accumulation are left
    alone), the partials are bf16, and the lanes for bf16 B: 2-line panels
    where B outgrows L2 and a row holds whole pairs of lines (reddit at
    kdim 128 and 512), else the f32-accumulate rule for bf16 B."""
    b = torch.from_numpy(np.random.default_rng(kdim).standard_normal(
        (8, kdim)).astype(np.float32))
    b16 = spmm_cuda.window_operand(b, torch.bfloat16)
    assert b16.dtype == torch.bfloat16 and torch.equal(b16, b.to(torch.bfloat16))
    assert spmm_cuda.window_operand(b16, torch.bfloat16) is b16
    assert spmm_cuda.window_operand(b, torch.float32) is b
    assert spmm_cuda.partial_dtype(torch.bfloat16) == torch.bfloat16
    assert spmm_cuda.partial_dtype(torch.float32) == torch.float32
    bf16 = torch.bfloat16
    assert spmm_cuda.lane_mapping(kdim, bf16, rows=rows, acc_dtype=bf16) == mapping
    if rows * kdim * 2 <= spmm_cuda.L2_BYTES or kdim % 8:
        assert mapping == spmm_cuda.lane_mapping(kdim, bf16, rows=rows)
    with pytest.raises(ValueError, match="accumulat"):
        spmm_cuda.window_operand(b, torch.float16)


def test_epilogue_refuses_partials_of_the_other_accumulator():
    ta, _, b = _case(80, 0.06, 0.9, 6, 2)
    steps = texe.device_step_arrays(tsched.build_balanced_schedule(ta, 16, 8), "cpu")
    tb = torch.from_numpy(b)
    p32 = spmm_cuda.spmm_window(steps, tb)
    p16 = spmm_cuda.spmm_window(steps, tb, acc_dtype=torch.bfloat16)
    assert (p32.dtype, p16.dtype) == (torch.float32, torch.bfloat16)
    for fn in (spmm_cuda.spmm_epilogue, spmm_cuda.spmm_epilogue_plain):
        with pytest.raises(ValueError, match="partial"):
            fn(steps, p16, torch.float32)
        with pytest.raises(ValueError, match="partial"):
            fn(steps, p32, torch.float32, acc_dtype=torch.bfloat16)
    # the same bits from an f32 B and from its bf16 values
    p16b = spmm_cuda.spmm_window(steps, tb.to(torch.bfloat16), acc_dtype=torch.bfloat16)
    assert torch.equal(p16, p16b)
    out = spmm_cuda.spmm_epilogue(steps, p16, torch.float32, acc_dtype=torch.bfloat16)
    assert torch.equal(out, spmm_cuda.spmm_balanced(steps, tb, acc_dtype=torch.bfloat16))


def test_plain_window_and_epilogue_with_unperm():
    ta, _, b = _case(120, 0.05, 0.9, 7, 3)
    s = tsched.build_balanced_schedule(ta, 16, 8, evil_threshold=8)
    steps = texe.device_step_arrays(s, "cpu")
    tb = torch.from_numpy(b)
    part = spmm_cuda.spmm_window(steps, tb)
    assert part.dtype == torch.float32
    assert part.shape == (steps.n_parts, 7)
    assert steps.n_parts == int(spmm_cuda.kernel_plan(s)["part_ptr"][-1])
    inv = torch.from_numpy(np.random.default_rng(3).permutation(120).astype(np.int32))
    full = spmm_cuda.spmm_epilogue(steps, part, torch.float32)
    unp = spmm_cuda.spmm_epilogue(steps, part, torch.bfloat16, inv)
    assert unp.dtype == torch.bfloat16
    torch.testing.assert_close(unp.float(), full[inv.long()].bfloat16().float())
    np.testing.assert_allclose(full.numpy(), tspmm.spmm_coo(ta, tb).numpy(), atol=1e-4)


def test_wrappers_never_fall_back_for_a_device_tensor():
    ta, _, b = _case(64, 0.05, 0.8, 4, 1)
    steps = texe.device_step_arrays(tsched.build_balanced_schedule(ta, 16, 8), "cpu")
    meta = torch.empty((64, 4), device="meta")
    with pytest.raises(ValueError, match="runs on CUDA"):
        spmm_cuda.spmm_window(steps, meta)
    with pytest.raises(ValueError, match="runs on CUDA"):
        spmm_cuda.spmm_epilogue(steps, torch.empty((8, 4), device="meta"),
                                torch.float32)


def test_ops_backends_and_refs():
    ta, ja, b = _case(60, 0.05, 0.8, 8, 5)
    s = tsched.build_balanced_schedule(ta, 16, 8)
    tb = torch.from_numpy(b)
    gold = np.asarray(jspmm.spmm_coo(ja, jnp.asarray(b)))
    assert ops.default_backend(tb) == "torch"
    for backend in (None, "torch", "cuda"):
        _check(ops.spmm(s, tb, backend=backend, ktile=8).numpy(), gold, "float32")
    with pytest.raises(ValueError, match="unknown backend"):
        ops.spmm(s, tb, backend="pallas")
    _check(ops.spmm_coo(ta, tb).numpy(), gold, "float32")
    _check(ref.spmm_ref(ta, tb).numpy(), gold, "float32")
    _check(ref.spmm_schedule_ref(s, tb).numpy(), gold, "float32")


def test_spmm_coo_family_matches_reference():
    ta, ja, b = _case(80, 0.06, 0.9, 10, 6)
    tb, jb = torch.from_numpy(b), jnp.asarray(b)
    tpad, jpad = tfmt.pad_coo(ta, ta.nnz + 5), jspmm.fmt.pad_coo(ja, ja.nnz + 5)
    _check(tspmm.spmm_coo(tpad, tb).numpy(), np.asarray(jspmm.spmm_coo(jpad, jb)),
           "float32")
    _check(tspmm.spmm_csc(tfmt.csc_from_coo(ta), tb).numpy(),
           np.asarray(jspmm.spmm_csc(jspmm.fmt.csc_from_coo(ja), jb)), "float32")
    _check(tspmm.spmm_coo_blocked(ta, tb, t=3).numpy(),
           np.asarray(jspmm.spmm_coo_blocked(ja, jb, t=3)), "float32")
    w = np.random.default_rng(6).standard_normal((10, 4)).astype(np.float32)
    _check(tspmm.gcn_layer_ref(ta, tb, torch.from_numpy(w)).numpy(),
           np.asarray(jspmm.gcn_layer_ref(ja, jb, jnp.asarray(w))), "float32")
    assert tspmm.flops_axw_orders(1000, (50, 30), (30, 8), 0.1) == \
        jspmm.flops_axw_orders(1000, (50, 30), (30, 8), 0.1)
    old = tspmm.GATHER_ELEMS
    try:  # many chunks must give the same product as one
        tspmm.GATHER_ELEMS = 37
        _check(tspmm.spmm_coo(ta, tb).numpy(), np.asarray(jspmm.spmm_coo(ja, jb)),
               "float32")
    finally:
        tspmm.GATHER_ELEMS = old


def test_ops_spmm_signature_matches_reference():
    import inspect

    from repro.kernels import ops as jops

    assert (list(inspect.signature(ops.spmm).parameters)
            == list(inspect.signature(jops.spmm).parameters))
    assert inspect.signature(ops.spmm).parameters["routing"].default == "auto"
    ta, _, b = _case(64, 0.05, 0.8, 5, 3)
    s = tsched.build_balanced_schedule(ta, 16, 8)
    bt = torch.from_numpy(b)
    want = ops.spmm(s, bt)
    for routing in ops.ROUTINGS:
        assert torch.equal(ops.spmm(s, bt, routing=routing), want)
    with pytest.raises(ValueError, match="routing"):
        ops.spmm(s, bt, routing="dense")


@pytest.mark.parametrize("kind", ["balanced", "blocked_evil", "naive"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bf16_accumulate_plain_matches_reference_executor(kind, dtype):
    """The bf16-accumulate variant's plain version (the kernel's rounding
    sequence) against the reference executor's bf16 gather routing, and both
    against the f32 product loosely (the reference's 0.1)."""
    from repro.core import executor as jexe

    ta, ja, b = _case(200, 0.05, 1.2, 9, 3)
    builders = {
        "balanced": lambda m, a: m.build_balanced_schedule(a, 16, 8),
        "blocked_evil": lambda m, a: m.build_balanced_schedule(
            a, 16, 8, cols_per_block=32, evil_threshold=8),
        "naive": lambda m, a: m.build_naive_schedule(a, 16, 8),
    }
    ts, js = builders[kind](tsched, ta), builders[kind](jsched, ja)
    bt = torch.from_numpy(b).to(dtype)
    got = spmm_cuda.spmm_balanced_plain(ts, bt, acc_dtype=torch.bfloat16)
    assert got.dtype == dtype
    assert torch.equal(got, spmm_cuda.spmm_balanced(ts, bt, acc_dtype=torch.bfloat16))
    want = np.asarray(jexe.ScheduleExecutor(js, routing="gather", bf16_accumulate=True)
                      .spmm(jnp.asarray(b, dtype=jnp.dtype(str(dtype)[6:]))),
                      dtype=np.float32)
    got32 = got.float().numpy()
    np.testing.assert_allclose(got32, want, atol=3e-2 * max(1.0, np.abs(want).max()))
    gold = np.asarray(jspmm.spmm_coo(ja, jnp.asarray(b)))
    np.testing.assert_allclose(got32, gold, atol=0.1)
    # the partials are bf16 rows, as the kernel writes them
    steps = texe.device_step_arrays(ts, "cpu")
    part = spmm_cuda.spmm_window_plain(steps, bt, acc_dtype=torch.bfloat16)
    assert part.dtype == torch.bfloat16 and part.shape == (steps.n_parts, 9)
    with pytest.raises(ValueError, match="accumulat"):
        spmm_cuda.spmm_window_plain(steps, bt, acc_dtype=torch.float16)
