"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; run them
on the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports no JAX, so it runs where only PyTorch is installed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
        assert spmm_cuda.LAUNCHES == {"spmm_balanced": 2, "spmm_epilogue": 2}
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
    with pytest.raises(NotImplementedError):
        texe.ScheduleExecutor(tsched.build_balanced_schedule(a, 16, 8),
                              bf16_accumulate=True, device=dev)
