"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; run them
on the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports no JAX, so it runs where only PyTorch is installed."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import csc as tfmt  # noqa: E402
from repro_torch.core import executor as texe  # noqa: E402
from repro_torch.core import gcn as tgcn  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core import spmm as tspmm  # noqa: E402
from repro_torch.graphs import synth as tsynth  # noqa: E402
from repro_torch.kernels import spmm_cuda  # noqa: E402
from repro_torch.tuning import registry as treg  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    treg.clear_caches()
    yield torch.device("cuda", torch.cuda.current_device())
    treg.clear_caches()


def _tol(gold, dtype):
    scale = max(1.0, float(gold.abs().max()))
    return (1e-4 if dtype == torch.float32 else 3e-2) * scale


#: schedule kinds: the default one-step windows, and output slots whose
#: sums span steps (column blocks with evil rows, wide windows, naive)
SCHEDULES = {
    "balanced": lambda a: tsched.build_balanced_schedule(a, 32, 16),
    "blocked_evil": lambda a: tsched.build_balanced_schedule(
        a, 16, 8, cols_per_block=32, evil_threshold=8),
    "wide_windows": lambda a: tsched.build_balanced_schedule(a, 16, 8, window_nnz=64),
    "naive": lambda a: tsched.build_naive_schedule(a, 16, 8),
}


@pytest.mark.parametrize("n,density,alpha", [
    (64, 0.05, 0.8), (200, 0.02, 1.1), (123, 0.08, 0.6)])
@pytest.mark.parametrize("kdim", [1, 3, 4, 5, 16, 24, 41, 128, 164, 300, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_versions(dev, n, density, alpha, kdim, dtype):
    a = tsynth.power_law_adjacency(n, density, alpha, seed=n)
    b = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (n, kdim)).astype(np.float32)).to(dev)
    gold = tspmm.spmm_coo(a, b)
    for build in SCHEDULES.values():
        steps = texe.device_step_arrays(build(a), dev)
        before = dict(spmm_cuda.LAUNCHES)
        bd = b.to(dtype)
        got = spmm_cuda.spmm_balanced(steps, bd, ktile=8)
        torch.cuda.synchronize()
        assert spmm_cuda.LAUNCHES["spmm_balanced"] == before["spmm_balanced"] + 1
        assert spmm_cuda.LAUNCHES["spmm_epilogue"] == before["spmm_epilogue"] + 1
        assert got.dtype == dtype and got.is_cuda
        assert float((got.float() - gold).abs().max()) <= _tol(gold, dtype)
        w_k = spmm_cuda.spmm_window(steps, bd)
        w_p = spmm_cuda.spmm_window_plain(steps, bd)
        assert w_k.shape == w_p.shape == (steps.n_parts, kdim)
        assert float((w_k - w_p).abs().max()) <= _tol(w_p, torch.float32)
        e_k = spmm_cuda.spmm_epilogue(steps, w_p, dtype)
        e_p = spmm_cuda.spmm_epilogue_plain(steps, w_p, dtype)
        assert torch.equal(e_k, e_p) or float(
            (e_k.float() - e_p.float()).abs().max()) <= _tol(e_p.float(), dtype)


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
@pytest.mark.parametrize("kdim", [41, 164])
def test_unaligned_operand_takes_scalar_gathers(dev, kind, kdim):
    a = tsynth.power_law_adjacency(150, 0.04, 1.0, seed=9)
    steps = texe.device_step_arrays(SCHEDULES[kind](a), dev)
    base = torch.randn((150 * kdim + 1,), device=dev)
    b = base[1:].view(150, kdim)  # 4 bytes past a 16-byte boundary
    assert b.data_ptr() % 16 != 0
    gold = tspmm.spmm_coo(a, b)
    got = spmm_cuda.spmm_balanced(steps, b)
    assert float((got - gold).abs().max()) <= _tol(gold, torch.float32)
    # the epilogue on partials 4 bytes past a 16-byte boundary: scalar loads,
    # the same sums in the same order as on the aligned partials
    part = spmm_cuda.spmm_window(steps, b)
    shifted = torch.empty((part.numel() + 1,), device=dev)[1:].view_as(part)
    shifted.copy_(part)
    assert shifted.data_ptr() % 16 != 0
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(spmm_cuda.spmm_epilogue(steps, shifted, dtype),
                           spmm_cuda.spmm_epilogue(steps, part, dtype))


@pytest.mark.parametrize("kdim,dtype", [
    (128, torch.float32), (512, torch.float32), (512, torch.bfloat16)])
def test_line_panels_match_plain(dev, kdim, dtype):
    # B larger than L2 with line-multiple rows: one 128-byte panel a pass
    n = 120_000
    a = tsynth.power_law_adjacency(n, 0.0001, 1.0, seed=5)
    steps = texe.device_step_arrays(tsched.build_balanced_schedule(a), dev)
    b = torch.randn((n, kdim), device=dev).to(dtype)
    vec, gw, nc, panels = spmm_cuda.lane_mapping(kdim, dtype, rows=n)
    assert gw * nc * vec * b.element_size() == spmm_cuda.LINE_BYTES and panels > 1
    w_k = spmm_cuda.spmm_window(steps, b)
    w_p = spmm_cuda.spmm_window_plain(steps, b)
    assert float((w_k - w_p).abs().max()) <= _tol(w_p, torch.float32)
    got = spmm_cuda.spmm_balanced(steps, b)
    gold = tspmm.spmm_coo(a, b.float())
    assert float((got.float() - gold).abs().max()) <= _tol(gold, dtype)
    assert torch.equal(spmm_cuda.spmm_balanced(steps, b), got)


@pytest.mark.parametrize("reorder", ["degree", "island"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reordered_schedule_matches_plain(dev, reorder, dtype):
    a = tsynth.power_law_adjacency(300, 0.03, 0.9, seed=7)
    ex = treg.get_executor(a, nnz_per_step=32, rows_per_window=16, reorder=reorder,
                           device=dev)
    assert ex._unperm is not None
    b = torch.randn((300, 164), device=dev).to(dtype)
    got = spmm_cuda.spmm_balanced(ex._steps, b, row_unperm=ex._unperm)
    plain = spmm_cuda.spmm_balanced_plain(ex._steps, b, row_unperm=ex._unperm)
    gold = tspmm.spmm_coo(a, b.float())
    err = float((got.float() - plain.float()).abs().max())
    assert err <= _tol(plain.float(), dtype)
    assert float((got.float() - gold).abs().max()) <= _tol(gold, dtype)


@pytest.mark.parametrize("n,alpha,evil,kdim", [
    (500, 1.0, 8, 64), (3000, 1.6, None, 164)])
def test_kernel_is_deterministic(dev, n, alpha, evil, kdim):
    a = tsynth.power_law_adjacency(n, 0.05, alpha, seed=3)
    k, r = (32, 16) if evil else (256, 64)
    s = tsched.build_balanced_schedule(a, k, r, evil_threshold=evil)
    assert s.n_evil_chunks > 0
    b = torch.randn((n, kdim), device=dev)
    first = spmm_cuda.spmm_balanced(s, b)
    for _ in range(3):
        assert torch.equal(spmm_cuda.spmm_balanced(s, b), first)


def test_executor_paths_launch_the_kernels(dev):
    a = tsynth.power_law_adjacency(300, 0.03, 0.9, seed=7)
    params = tgcn.params_from_jax({
        "w0": np.random.default_rng(0).uniform(-0.3, 0.3, (20, 16)).astype(np.float32),
        "w1": np.random.default_rng(1).uniform(-0.3, 0.3, (16, 5)).astype(np.float32),
    }, dev)
    xs = torch.rand((3, 300, 20), device=dev)
    for routing in ("gather", "onehot"):
        ex = treg.get_executor(a, nnz_per_step=32, rows_per_window=16, reorder="island",
                               routing=routing, device=dev)
        spmm_cuda.reset_launches()
        out = ex.forward_batch(params, xs)
        assert spmm_cuda.LAUNCHES == {"spmm_balanced": 2, "spmm_epilogue": 2,
                                      "spmm_balanced_bf16acc": 0,
                                      "spmm_epilogue_bf16acc": 0}
        for i in range(3):
            gold = tgcn.forward(params, a, xs[i])
            assert float((out[i] - gold).abs().max()) <= _tol(gold, torch.float32)


def test_wrapper_rejects_bad_operands(dev):
    a = tsynth.power_law_adjacency(64, 0.05, 0.8, seed=1)
    steps = texe.device_step_arrays(tsched.build_balanced_schedule(a, 16, 8), dev)
    with pytest.raises(ValueError):
        spmm_cuda.spmm_window(steps, torch.zeros((63, 4), device=dev))
    with pytest.raises(ValueError):
        spmm_cuda.spmm_window(
            steps, torch.zeros((64, 4), device=dev, dtype=torch.float64))
    with pytest.raises(ValueError):
        spmm_cuda.spmm_window(steps, torch.zeros((4, 64), device=dev).t())
    with pytest.raises(ValueError, match="accumulat"):
        spmm_cuda.spmm_window(steps, torch.zeros((64, 4), device=dev),
                              acc_dtype=torch.float16)


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
@pytest.mark.parametrize("kdim", [1, 4, 5, 16, 41, 128, 164, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bf16acc_kernels_match_plain_and_are_deterministic(dev, kind, kdim, dtype):
    """The bf16-accumulate variant against its plain version bit for bit
    (each kernel takes the plain version's rounding sequence in its order),
    against the f32 COO product at the reference's loose 0.1, apart from the
    f32 kernels' result on the same inputs, and two calls bit-equal."""
    a = tsynth.power_law_adjacency(200, 0.05, 1.2, seed=kdim)
    steps = texe.device_step_arrays(SCHEDULES[kind](a), dev)
    b = torch.from_numpy(np.random.default_rng(kdim).standard_normal(
        (200, kdim)).astype(np.float32)).to(dev).to(dtype)
    unperm = torch.from_numpy(np.random.default_rng(1).permutation(200).astype(
        np.int32)).to(dev)
    before = dict(spmm_cuda.LAUNCHES)
    got = spmm_cuda.spmm_balanced(steps, b, acc_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert spmm_cuda.LAUNCHES["spmm_balanced_bf16acc"] == before["spmm_balanced_bf16acc"] + 1
    assert spmm_cuda.LAUNCHES["spmm_epilogue_bf16acc"] == before["spmm_epilogue_bf16acc"] + 1
    assert spmm_cuda.LAUNCHES["spmm_balanced"] == before["spmm_balanced"]
    plain = spmm_cuda.spmm_balanced_plain(steps, b, acc_dtype=torch.bfloat16)
    assert got.dtype == dtype
    assert torch.equal(got, plain)
    part = spmm_cuda.spmm_window(steps, b, acc_dtype=torch.bfloat16)
    part_p = spmm_cuda.spmm_window_plain(steps, b, acc_dtype=torch.bfloat16)
    assert part.dtype == torch.bfloat16 and torch.equal(part, part_p)
    for row_unperm in (None, unperm):
        assert torch.equal(
            spmm_cuda.spmm_epilogue(steps, part_p, dtype, row_unperm,
                                    acc_dtype=torch.bfloat16),
            spmm_cuda.spmm_epilogue_plain(steps, part_p, dtype, row_unperm,
                                          acc_dtype=torch.bfloat16))
    # an f32 B and the same values already in bf16 give the same bits: the
    # window rounds an f32 B once before it gathers
    b16 = b.to(torch.bfloat16)
    assert torch.equal(spmm_cuda.spmm_window(steps, b16, acc_dtype=torch.bfloat16), part)
    got16 = spmm_cuda.spmm_balanced(steps, b16, acc_dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16 and torch.equal(got16.to(dtype), got)
    # partials and accumulator of different dtypes are refused
    with pytest.raises(ValueError, match="partial"):
        spmm_cuda.spmm_epilogue(steps, part_p.float(), dtype, acc_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="partial"):
        spmm_cuda.spmm_epilogue(steps, part_p, dtype)
    gold = tspmm.spmm_coo(a, b.float())
    assert float((got.float() - gold).abs().max()) <= 0.1
    # dropping the variant (the f32 kernels under the bf16 name) must fail
    assert not torch.equal(got, spmm_cuda.spmm_balanced(steps, b))
    assert torch.equal(spmm_cuda.spmm_balanced(steps, b, acc_dtype=torch.bfloat16), got)


def test_bf16_rounding_check_finds_no_mismatch(dev):
    """mul.rn.bf16x2 and add.rn.bf16x2 round as the written-out f32
    sequence of the plain versions on all 2^32 pairs of bf16 patterns."""
    assert spmm_cuda.bf16_rounding_check(dev) == (0, 0)


@pytest.mark.parametrize("kdim,vec", [(128, 8), (512, 8), (41, 1), (128, 1)])
@pytest.mark.parametrize("gw", spmm_cuda.GROUP_WIDTHS)
@pytest.mark.parametrize("nc", range(1, spmm_cuda.MAX_VECTORS + 1))
def test_bf16acc_every_lane_mapping_matches_plain(dev, kdim, vec, gw, nc):
    """Every instantiation of the bf16-accumulate window (16-byte and
    scalar gathers, 1-4 vectors a lane, each group width), with its column
    panels, bit-equal to the plain version."""
    a = tsynth.power_law_adjacency(300, 0.04, 1.2, seed=gw + nc)
    steps = texe.device_step_arrays(SCHEDULES["blocked_evil"](a), dev)
    b = torch.from_numpy(np.random.default_rng(nc).standard_normal(
        (300, kdim)).astype(np.float32)).to(dev).to(torch.bfloat16)
    mapping = (vec, gw, nc, -(-kdim // (vec * gw * nc)))
    got = spmm_cuda._window(steps, b, mapping, torch.bfloat16)
    assert torch.equal(got, spmm_cuda.spmm_window_plain(steps, b, acc_dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="bfloat16"):
        spmm_cuda._window(steps, b.float(), mapping, torch.bfloat16)


def test_bf16_accumulate_executor_runs_on_the_card(dev):
    a = tsynth.power_law_adjacency(300, 0.03, 0.9, seed=7)
    s = tsched.build_balanced_schedule(a, 32, 16)
    ex = texe.ScheduleExecutor(s, bf16_accumulate=True, device=dev)
    b = torch.randn((300, 24), device=dev)
    spmm_cuda.reset_launches()
    got = ex.spmm(b)
    assert spmm_cuda.LAUNCHES["spmm_balanced_bf16acc"] == 1
    assert spmm_cuda.LAUNCHES["spmm_balanced"] == 0
    plain = spmm_cuda.spmm_balanced_plain(s, b, acc_dtype=torch.bfloat16)
    assert torch.equal(got, plain)
    assert not torch.equal(got, texe.ScheduleExecutor(s, device=dev).spmm(b))
    assert float((got - tspmm.spmm_coo(a, b)).abs().max()) <= 0.1


def test_cuda_spellings_share_one_executor_and_upload(dev):
    a = tsynth.power_law_adjacency(300, 0.03, 0.9, seed=8)
    ex = treg.get_executor(a, nnz_per_step=32, rows_per_window=16)
    assert treg.get_executor(a, nnz_per_step=32, rows_per_window=16, device="cuda") is ex
    assert treg.get_executor(a, nnz_per_step=32, rows_per_window=16,
                             device=torch.device("cuda")) is ex
    sched = ex.sched
    assert [k for k in texe._DEVICE_STEPS if k[0] == id(sched)] == [(id(sched), str(dev))]
    texe.release_device_steps(sched, device="cuda")
    assert [k for k in texe._DEVICE_STEPS if k[0] == id(sched)] == []


def test_autotune_on_the_card_attaches_the_bf16_report(dev):
    from repro_torch.tuning import runner

    a = tsynth.power_law_adjacency(2000, 0.01, 1.0, seed=3)
    spmm_cuda.reset_launches()
    cfg = runner.autotune(a, (2000, 16), iters=2, warmup=1)
    assert cfg.bf16_max_err is not None and 0 < cfg.bf16_max_err < 0.5
    assert not cfg.bf16_accumulate and cfg.measured_us > 0
    assert spmm_cuda.LAUNCHES["spmm_balanced"] > 0
    assert spmm_cuda.LAUNCHES["spmm_balanced_bf16acc"] == 1


def test_engine_warm_start_on_the_card(dev, tmp_path, monkeypatch):
    from repro_torch.serving.gcn_engine import GCNServingEngine
    from repro_torch.tuning import runner

    a = tsynth.power_law_adjacency(3000, 0.005, 1.0, seed=4)
    rng = np.random.default_rng(4)
    params = tgcn.params_from_jax({
        "w0": rng.uniform(-0.3, 0.3, (32, 16)).astype(np.float32),
        "w1": rng.uniform(-0.3, 0.3, (16, 5)).astype(np.float32)}, dev)
    xs = [torch.rand((3000, 32), device=dev) for _ in range(3)]
    kw = dict(iters=1, warmup=1, sweep=[dict(
        nnz_per_step=k, rows_per_window=32, cols_per_block=None, window_nnz=None,
        routing="gather") for k in (128, 256)])
    eng = GCNServingEngine(store_root=tmp_path, max_batch=2, autotune_kwargs=kw)
    rep = eng.add_graph("g", a, params)
    assert not rep.warm_start and rep.config.bf16_max_err is not None
    for x in xs:
        eng.submit("g", x, deadline_s=10.0)
    out = eng.flush()["g"]
    assert out.is_cuda and out.shape == (3, 3000, 5)
    for i, x in enumerate(xs):
        gold = tgcn.forward(params, a, x)
        assert float((out[i] - gold).abs().max()) <= _tol(gold, torch.float32)
    treg.clear_caches()
    monkeypatch.setattr(runner, "measure_candidate",
                        lambda *a_, **k: pytest.fail("sweep on warm start"))
    monkeypatch.setattr(tsched, "build_balanced_schedule",
                        lambda *a_, **k: pytest.fail("rebuild on warm start"))
    eng2 = GCNServingEngine(store_root=tmp_path, max_batch=2, autotune_kwargs=kw)
    rep2 = eng2.add_graph("g", a, params)
    assert rep2.warm_start and rep2.tune_seconds == 0.0 and rep2.config == rep.config
    for x in xs:  # the same batches as the cold engine served
        eng2.submit("g", x, deadline_s=10.0)
    assert torch.equal(eng2.flush()["g"], out)


def test_engine_counts_host_requests_it_copies_to_the_card(dev, tmp_path):
    """Requests already on the card reach X·W with no copy; a host array or
    a host tensor is moved on its own, and ``requests_copied`` counts it."""
    from repro_torch.serving.gcn_engine import GCNServingEngine

    a = tsynth.power_law_adjacency(3000, 0.005, 1.0, seed=6)
    rng = np.random.default_rng(6)
    params = tgcn.params_from_jax({
        "w0": rng.uniform(-0.3, 0.3, (32, 16)).astype(np.float32),
        "w1": rng.uniform(-0.3, 0.3, (16, 5)).astype(np.float32)}, dev)
    kw = dict(iters=1, warmup=1, bf16_report=False, sweep=[dict(
        nnz_per_step=128, rows_per_window=32, cols_per_block=None, window_nnz=None,
        routing="gather")])
    eng = GCNServingEngine(store_root=tmp_path, autotune_kwargs=kw)
    eng.add_graph("g", a, params)
    host = rng.random((3000, 32)).astype(np.float32)
    on_card = torch.from_numpy(host).to(dev)
    ref = eng.serve_batch("g", [on_card, on_card])
    eng.submit("g", on_card)
    eng.flush()
    assert eng.stats()["requests_copied"] == 0
    out = eng.serve_batch("g", [host, on_card, torch.from_numpy(host)])
    assert eng.stats()["requests_copied"] == 2
    for i in range(3):
        torch.testing.assert_close(out[i], ref[0])


# ---------------------------------------------------------------------------
# streaming updates on the card: repaired and value-patched executors
# ---------------------------------------------------------------------------


def _update_case(n, seed):
    """A graph, its schedule and executor on the card, a value patch and a
    structural repair of it."""
    from repro_torch.core import csc as tfmt

    a = tsynth.power_law_adjacency(n, 0.01, 1.0, seed=seed)
    rng = np.random.default_rng(seed)
    sched = tsched.build_balanced_schedule(a, 64, 32)
    row, col = tfmt.to_numpy(a.row), tfmt.to_numpy(a.col)
    pick = rng.choice(row.shape[0], 16, replace=False)
    vp, slots = tsched.value_patch_schedule(
        sched, tsched.slot_entry_keys(sched), row[pick], col[pick],
        (rng.random(16) + 0.5).astype(np.float32))
    delta = tfmt.EdgeDelta(rng.integers(0, n, 24), rng.integers(0, n, 24),
                           (rng.random(24) + 0.1).astype(np.float32))
    new, rep = tfmt.apply_edge_delta(a, delta, with_report=True)
    pro = np.bincount(row.astype(np.int64), minlength=n)
    prn = pro.copy()
    prn[rep.touched_rows] += rep.row_nnz_delta
    rs, stats = tsched.repair_schedule(sched, None, new, rep.touched_rows,
                                       per_row_old=pro, per_row_new=prn,
                                       nnz_per_step=64, rows_per_window=32)
    return sched, (vp, slots), (rs, stats)


def test_streaming_executors_on_the_card(dev, monkeypatch):
    monkeypatch.setattr(texe, "SCOPED_UPLOAD_MIN_BYTES", 0)
    sched, (vp, slots), (rs, stats) = _update_case(4000, 11)
    ex = texe.ScheduleExecutor(sched, device=dev)
    before = [t.clone() for t in ex._steps[:5]]
    b = torch.rand((4000, 64), device=dev)
    for new_sched, make in (
            (vp, lambda: texe.value_patched_executor(ex, vp, slots, vp.val[slots])),
            (rs, lambda: texe.repaired_executor(ex, rs, stats))):
        spmm_cuda.reset_launches()
        new = make()
        assert spmm_cuda.LAUNCHES["spmm_balanced"] == 0  # building launches nothing
        cold = texe.ScheduleExecutor(dataclasses.replace(new_sched), device=dev)
        for got, want in zip(new._steps[:5], cold._steps[:5]):
            assert got.is_cuda and torch.equal(got, want)
        assert new._steps.n_parts == cold._steps.n_parts
        assert torch.equal(new.spmm(b), cold.spmm(b))
        assert texe.device_step_arrays(new_sched, dev) is new._steps
        assert all(torch.equal(t, c) for t, c in zip(ex._steps[:5], before))
    vex = texe.value_patched_executor(ex, vp, slots, vp.val[slots])
    assert vex.scoped_upload and vex._steps.slot_ptr is ex._steps.slot_ptr


def test_streaming_executors_never_replan_on_the_card(dev, monkeypatch):
    from repro_torch.core import csc as tfmt

    monkeypatch.setattr(texe, "SCOPED_UPLOAD_MIN_BYTES", 0)
    a = tsynth.power_law_adjacency(4000, 0.01, 1.0, seed=12)
    sched = tsched.build_balanced_schedule(a, 64, 32)
    ex = texe.ScheduleExecutor(sched, device=dev)
    row, col = tfmt.to_numpy(a.row), tfmt.to_numpy(a.col)
    r = int(row[0])
    c1 = int(np.setdiff1d(np.arange(4000), col[row == r])[0])
    delta = tfmt.EdgeDelta(np.array([r, r]), np.array([col[0], c1]),
                           np.array([0.0, 0.75], np.float32))
    new, rep = tfmt.apply_edge_delta(a, delta, with_report=True)
    pr = np.bincount(row.astype(np.int64), minlength=4000)
    rs, stats = tsched.repair_schedule(sched, None, new, rep.touched_rows,
                                       per_row_old=pr, per_row_new=pr,
                                       nnz_per_step=64, rows_per_window=32)
    vp, slots = tsched.value_patch_schedule(sched, tsched.slot_entry_keys(sched),
                                            row[1:3], col[1:3],
                                            np.array([2.0, 3.0], np.float32))
    monkeypatch.setattr(spmm_cuda, "kernel_plan", lambda s: pytest.fail("re-planned"))
    rex = texe.repaired_executor(ex, rs, stats)
    assert rex.scoped_upload
    vex = texe.value_patched_executor(ex, vp, slots, vp.val[slots])
    assert vex.scoped_upload
    b = torch.rand((4000, 16), device=dev)
    for e, s in ((rex, rs), (vex, vp)):
        gold = tspmm.spmm_coo(_sched_coo(s), b)
        assert float((e.spmm(b) - gold).abs().max()) <= _tol(gold, torch.float32)


def _sched_coo(sched):
    """The matrix a schedule encodes, as a COO on the card."""
    from repro_torch.core import csc as tfmt

    k, r, cb = sched.nnz_per_step, sched.rows_per_window, sched.cols_per_block
    keep = sched.val != 0
    slot = np.repeat(sched.win_id.astype(np.int64), k) * r + sched.local_row
    row = sched.row_map[slot][keep]
    col = (np.repeat(sched.col_block.astype(np.int64), k) * cb + sched.local_col)[keep]
    return tfmt.coo_from_arrays(row, col, sched.val[keep], sched.shape)


def test_engine_update_chain_on_the_card(dev, tmp_path):
    import gc

    from repro_torch.core import csc as tfmt
    from repro_torch.serving.gcn_engine import GCNServingEngine

    n = 3000
    a = tsynth.power_law_adjacency(n, 0.005, 1.0, seed=13)
    rng = np.random.default_rng(13)
    params = tgcn.params_from_jax({
        "w0": rng.uniform(-0.3, 0.3, (32, 16)).astype(np.float32),
        "w1": rng.uniform(-0.3, 0.3, (16, 5)).astype(np.float32)}, dev)
    x = torch.rand((n, 32), device=dev)
    kw = dict(iters=1, warmup=1, bf16_report=False, sweep=[dict(
        nnz_per_step=64, rows_per_window=32, cols_per_block=None, window_nnz=None,
        routing="gather")])
    # cuBLAS takes its workspace (32 MiB) from the allocator at the first
    # product on this stream: take it before the baseline
    torch.relu(x @ params["w0"]) @ params["w1"]
    torch.cuda.synchronize()
    gc.collect()
    base = torch.cuda.memory_allocated(dev)
    eng = GCNServingEngine(store_root=tmp_path, autotune_kwargs=kw)
    eng.add_graph("g", a, params)
    eng.infer("g", x)
    for i in range(6):
        coo = eng._graphs["g"].coo
        row, col = tfmt.to_numpy(coo.row), tfmt.to_numpy(coo.col)
        if i % 2 == 0:
            pick = rng.choice(row.shape[0], 8, replace=False)
            delta = tfmt.EdgeDelta(row[pick], col[pick],
                                   (rng.random(8) + 0.5).astype(np.float32))
        else:
            delta = tfmt.EdgeDelta(rng.integers(0, n, 8), rng.integers(0, n, 8),
                                   (rng.random(8) + 0.1).astype(np.float32))
        rep = eng.update_graph("g", delta)
        assert rep.repaired and not rep.fell_back
        assert rep.scoped_upload or i % 2 == 1
    got = eng.infer("g", x)
    rec = eng._graphs["g"]
    gold = tgcn.forward(params, rec.coo._replace(
        row=rec.coo.row.to(dev), col=rec.coo.col.to(dev), val=rec.coo.val.to(dev)), x)
    assert float((got - gold).abs().max()) <= _tol(gold, torch.float32)
    eng.drain_persists()
    del got, gold
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev) - base
    # the engine's accounting, up to the allocator's rounding
    assert abs(held - eng.device_bytes_in_use) <= (1 << 20), (
        held, eng.device_bytes_in_use)


# ---- make_spmm_fn: the kernels forward on A, backward on Aᵀ --------------------

def _spmm_fn_pair(a, kind, dev):
    """``make_spmm_fn`` with the kernels and with their plain versions on one
    schedule pair (A's and Aᵀ's of one ``SCHEDULES`` kind)."""
    pair = (SCHEDULES[kind](a), SCHEDULES[kind](tfmt.transpose_coo(a)))
    return (spmm_cuda.make_spmm_fn(a, schedules=pair),
            spmm_cuda.make_spmm_fn(a, schedules=pair, backend="torch"))


@pytest.mark.parametrize("kind", ["balanced", "blocked_evil"])
@pytest.mark.parametrize("kdim", [6, 41, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_make_spmm_fn_grads_match_plain(dev, kind, kdim, dtype):
    a = tsynth.power_law_adjacency(96, 0.1, 1.2, seed=4)
    f, plain = _spmm_fn_pair(a, kind, dev)
    if kind == "blocked_evil":
        assert f.sched.n_evil_chunks > 0 and f.sched_t.n_evil_chunks > 0
    rng = np.random.default_rng(kdim)
    b0 = torch.from_numpy(rng.standard_normal((96, kdim)).astype(np.float32)).to(dev)
    dc = torch.from_numpy(rng.standard_normal((96, kdim)).astype(np.float32)).to(dev)
    grads, outs = [], []
    for fn in (f, plain, f):
        b = b0.to(dtype).requires_grad_()
        out = fn(b)
        (db,) = torch.autograd.grad(out, b, dc.to(dtype))
        outs.append(out.detach())
        grads.append(db)
    dense_t = tfmt.coo_to_dense(a).t().to(dev)
    gold = dense_t @ dc
    assert grads[0].dtype == dtype
    assert float((grads[0].float() - gold).abs().max()) <= _tol(gold, dtype)
    assert float((grads[0].float() - grads[1].float()).abs().max()) <= _tol(gold, dtype)
    err = float((outs[0].float() - outs[1].float()).abs().max())
    assert err <= _tol(outs[1].float(), dtype)
    assert torch.equal(grads[0], grads[2]) and torch.equal(outs[0], outs[2])


def test_make_spmm_fn_launches_once_per_pass(dev):
    a = tsynth.power_law_adjacency(200, 0.02, 1.1, seed=200)
    f, _ = _spmm_fn_pair(a, "balanced", dev)
    b = torch.randn((200, 16), device=dev, requires_grad=True)
    spmm_cuda.reset_launches()
    out = f(b)
    torch.cuda.synchronize()
    assert spmm_cuda.LAUNCHES["spmm_balanced"] == 1
    assert spmm_cuda.LAUNCHES["spmm_epilogue"] == 1
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert spmm_cuda.LAUNCHES["spmm_balanced"] == 2
    assert spmm_cuda.LAUNCHES["spmm_epilogue"] == 2


def test_make_spmm_fn_backward_takes_any_layout_of_dc(dev):
    a = tsynth.power_law_adjacency(123, 0.08, 0.6, seed=123)
    f, plain = _spmm_fn_pair(a, "blocked_evil", dev)
    gold_t = tfmt.coo_to_dense(a).t().to(dev)
    b = torch.randn((123, 41), device=dev, requires_grad=True)
    f(b).sum().backward()  # a stride-0 expansion of one scalar
    gold = gold_t @ torch.ones((123, 41), device=dev)
    assert float((b.grad - gold).abs().max()) <= _tol(gold, torch.float32)
    wide = torch.randn((123, 50), device=dev)
    for dc in (wide.t().contiguous().t()[:, :41], wide[:, 3:44], wide[:, 1:42]):
        assert not dc.is_contiguous()
        (db,) = torch.autograd.grad(f(b), b, dc)
        (dp,) = torch.autograd.grad(plain(b), b, dc)
        gold = gold_t @ dc
        assert float((db - gold).abs().max()) <= _tol(gold, torch.float32)
        assert float((db - dp).abs().max()) <= _tol(gold, torch.float32)


def test_make_spmm_fn_uploads_once_across_steps(dev, monkeypatch):
    a = tsynth.power_law_adjacency(200, 0.02, 1.1, seed=7)
    uploads = []
    real = texe._upload_plan
    monkeypatch.setattr(texe, "_upload_plan",
                        lambda *a, **k: uploads.append(1) or real(*a, **k))
    f = spmm_cuda.make_spmm_fn(a, nnz_per_step=32, rows_per_window=16)
    w = torch.randn((8, 8), device=dev, requires_grad=True)
    x = torch.randn((200, 8), device=dev)
    for _ in range(3):
        torch.relu(f(x @ w)).sum().backward()
        texe._DEVICE_STEPS.clear()  # the executor cache's eviction
    torch.cuda.synchronize()
    assert len(uploads) == 2


# ---------------------------------------------------------------------------
# the sharded executor on a mesh of positions on the card
# ---------------------------------------------------------------------------


def _launches():
    return dict(spmm_cuda.LAUNCHES)


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("kind", ["balanced", "blocked_evil"])
@pytest.mark.parametrize("acc", [torch.float32, torch.bfloat16])
def test_sharded_kernels_match_plain_and_single_device(dev, monkeypatch, d, kind, acc):
    """Each position runs the window and epilogue kernels on its range: held
    against the same shards through the plain versions (a host mesh down
    the kernels' path), against the single-device kernels and the COO
    product; two calls bit-equal; D windows and D epilogues a call."""
    a = tsynth.power_law_adjacency(300, 0.03, 0.9, seed=7)
    sched = SCHEDULES[kind](a)
    bf16 = acc == torch.bfloat16
    b = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (300, 24)).astype(np.float32))
    ex = texe.ShardedScheduleExecutor(sched, mesh=[dev] * d, bf16_accumulate=bf16)
    assert ex._kernels and all(s.slots.is_cuda for s in ex._steps)
    before = _launches()
    got = ex.spmm(b.to(dev))
    torch.cuda.synchronize()
    suffix = "_bf16acc" if bf16 else ""
    assert spmm_cuda.LAUNCHES["spmm_balanced" + suffix] == before["spmm_balanced" + suffix] + d
    assert spmm_cuda.LAUNCHES["spmm_epilogue" + suffix] == before["spmm_epilogue" + suffix] + d
    assert torch.equal(got, ex.spmm(b.to(dev)))
    monkeypatch.setattr(texe, "_runs_kernels", lambda device: True)
    plain = texe.ShardedScheduleExecutor(sched, mesh=["cpu"] * d, bf16_accumulate=bf16)
    want = plain.spmm(b)
    single = texe.ScheduleExecutor(sched, device=dev, bf16_accumulate=bf16).spmm(b.to(dev))
    gold = tspmm.spmm_coo(a, b.to(dev))
    if bf16:  # the plain versions take the kernels' rounding sequence
        assert torch.equal(got.cpu(), want)
    else:
        assert float((got.cpu() - want).abs().max()) <= _tol(want, acc)
    assert float((got - single).abs().max()) <= _tol(single, acc)
    assert float((got - gold).abs().max()) <= (_tol(gold, acc) if not bf16 else 0.1)


def test_sharded_device_bytes_and_release(dev):
    """``device_bytes`` is what the positions uploaded (within the caching
    allocator's rounding), and ``release_device_steps`` frees the shards'
    uploads once their executor is gone."""
    import gc

    a = tsynth.power_law_adjacency(4000, 0.01, 1.0, seed=3)
    sched = tsched.build_balanced_schedule(a, 64, 32)
    inv = np.random.default_rng(3).permutation(4000).astype(np.int32)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    ex = texe.ShardedScheduleExecutor(sched, mesh=[dev] * 4, row_unperm=inv)
    torch.cuda.synchronize()
    used = torch.cuda.memory_allocated(dev) - base
    n_tensors = 4 * len(spmm_cuda.DEVICE_FIELDS) + 1
    assert ex.device_bytes == sum(s.nbytes for s in ex._steps) + inv.nbytes
    assert ex.device_bytes <= used <= ex.device_bytes + 512 * n_tensors
    keys = [k for k in texe._DEVICE_STEPS if k[0] == id(sched)]
    assert len(keys) == 4 and all(k[2][0] == "shard" for k in keys)
    del ex
    gc.collect()
    assert torch.cuda.memory_allocated(dev) - base > 0  # the memo still holds them
    texe.release_device_steps(sched)
    gc.collect()
    assert torch.cuda.memory_allocated(dev) == base


def test_sharded_streaming_executors_on_the_card(dev, monkeypatch):
    monkeypatch.setattr(texe, "SCOPED_UPLOAD_MIN_BYTES", 0)
    sched, (vp, slots), (rs, stats) = _update_case(4000, 11)
    ex = texe.ShardedScheduleExecutor(sched, mesh=[dev] * 4)
    b = torch.rand((4000, 64), device=dev)
    for new_sched, make in (
            (vp, lambda: texe.value_patched_executor(ex, vp, slots, vp.val[slots])),
            (rs, lambda: texe.repaired_executor(ex, rs, stats))):
        before = _launches()
        new = make()
        assert _launches() == before  # building launches nothing
        cold = texe.ShardedScheduleExecutor(dataclasses.replace(new_sched), mesh=[dev] * 4)
        for got, want in zip(new._steps, cold._steps):
            for g, w in zip(got[:5], want[:5]):
                assert g.is_cuda and torch.equal(g, w)
        assert torch.equal(new.spmm(b), cold.spmm(b))
    # the value patch went only to the positions holding a patched slot
    vex = texe.value_patched_executor(ex, vp, slots, vp.val[slots])
    owners = set(np.searchsorted(ex.step_ranges[:, 1], slots // sched.nnz_per_step,
                                 side="right").tolist())
    assert vex.dirty_devices == len(owners)
    for d in range(4):
        if d not in owners:
            assert vex._steps[d] is ex._steps[d]


def test_mesh_engine_on_one_card(dev, tmp_path):
    """Four positions on one card: the sharded route for a graph over the
    budget, a hot graph's replicas equal to a one-replica engine's bit for
    bit, and a failed replica chunk retried on a sibling."""
    from repro_torch.core.executor import FAULTS
    from repro_torch.serving.gcn_engine import GCNServingEngine
    from repro_torch.serving.placement import REPLICATED, SHARDED

    kw = dict(iters=1, warmup=1, bf16_report=False, sweep=[dict(
        nnz_per_step=64, rows_per_window=32, cols_per_block=None, window_nnz=None,
        routing="gather")])
    rng = np.random.default_rng(5)
    params = tgcn.params_from_jax({
        "w0": rng.uniform(-0.3, 0.3, (16, 16)).astype(np.float32),
        "w1": rng.uniform(-0.3, 0.3, (16, 4)).astype(np.float32)}, dev)
    giant = tsynth.power_law_adjacency(3000, 0.01, 0.9, seed=99)
    hot = tsynth.power_law_adjacency(300, 0.03, 0.9, seed=5)
    eng = GCNServingEngine(store_root=tmp_path, devices=[dev] * 4, max_replicas=3,
                           replicate_after_s=1e-6, replica_shrink_after=10**6,
                           device_budget_bytes=giant.nnz * 4, autotune_kwargs=kw)
    assert eng.add_graph("giant", giant, params).placement.kind == SHARDED
    x = torch.rand((3000, 16), device=dev)
    before = _launches()
    out = eng.infer("giant", x)
    assert spmm_cuda.LAUNCHES["spmm_balanced"] - before["spmm_balanced"] == 2 * 4
    gold = tgcn.forward(params, giant, x)
    assert float((out - gold).abs().max()) <= _tol(gold, torch.float32)
    one = GCNServingEngine(store_root=tmp_path, devices=[dev] * 4, max_replicas=1,
                           autotune_kwargs=kw)
    one.add_graph("hot", hot, params)
    eng.add_graph("hot", hot, params)
    reqs = [torch.rand((300, 16), device=dev) for _ in range(12)]
    ref = one.serve_batch("hot", reqs)
    eng.serve_batch("hot", reqs[:2])
    for _ in range(3):
        for r in reqs:
            eng.submit("hot", r, deadline_s=0.0)
        assert torch.equal(eng.poll()["hot"], ref)
    assert eng.placer.placement_of("hot").kind == REPLICATED
    victim = sorted(eng._graphs["hot"].replicas)[0]
    FAULTS.clear()
    FAULTS.arm("replica_chunk", graph="hot", device=victim, times=1)
    try:
        assert torch.equal(eng.serve_batch("hot", reqs), ref)
        assert FAULTS.fired == [("replica_chunk", "hot", victim)]
    finally:
        FAULTS.clear()
    assert eng.counters["request_failures"] == 0 and eng.counters["chunk_retries"] >= 1
