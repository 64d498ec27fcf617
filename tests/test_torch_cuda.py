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


@pytest.mark.parametrize("n,density,alpha", [
    (64, 0.05, 0.8), (200, 0.02, 1.1), (123, 0.08, 0.6)])
@pytest.mark.parametrize("kdim", [5, 16, 24, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_versions(dev, n, density, alpha, kdim, dtype):
    a = tsynth.power_law_adjacency(n, density, alpha, seed=n)
    b = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (n, kdim)).astype(np.float32)).to(dev)
    gold = tspmm.spmm_coo(a, b)
    for sched in (tsched.build_balanced_schedule(a, 32, 16),
                  tsched.build_balanced_schedule(a, 16, 8, cols_per_block=32,
                                                 evil_threshold=8),
                  tsched.build_naive_schedule(a, 16, 8)):
        steps = texe.device_step_arrays(sched, dev)
        before = dict(spmm_cuda.LAUNCHES)
        bd = b.to(dtype)
        got = spmm_cuda.spmm_balanced(steps, bd, ktile=8)
        torch.cuda.synchronize()
        assert spmm_cuda.LAUNCHES["spmm_balanced"] == before["spmm_balanced"] + 1
        assert spmm_cuda.LAUNCHES["spmm_epilogue"] == before["spmm_epilogue"] + 1
        assert got.dtype == dtype and got.is_cuda
        assert float((got.float() - gold).abs().max()) <= _tol(gold, dtype)
        live = steps.row_map >= 0
        w_k = spmm_cuda.spmm_window(steps, bd)
        w_p = spmm_cuda.spmm_window_plain(steps, bd)
        assert float((w_k[live] - w_p[live]).abs().max()) <= _tol(w_p, torch.float32)
        e_k = spmm_cuda.spmm_epilogue(steps, w_p, dtype)
        e_p = spmm_cuda.spmm_epilogue_plain(steps, w_p, dtype)
        assert torch.equal(e_k, e_p) or float(
            (e_k.float() - e_p.float()).abs().max()) <= _tol(e_p.float(), dtype)


def test_kernel_is_deterministic(dev):
    a = tsynth.power_law_adjacency(500, 0.05, 1.0, seed=3)
    s = tsched.build_balanced_schedule(a, 32, 16, evil_threshold=8)
    b = torch.randn((500, 64), device=dev)
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
