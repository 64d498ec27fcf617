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


def test_kernel_plan_indexes_windows_and_live_slots():
    ta, _, _ = _case(96, 0.1, 1.2, 1, 4)
    s = tsched.build_balanced_schedule(ta, 16, 8, cols_per_block=32, evil_threshold=8)
    plan = spmm_cuda.kernel_plan(s)
    ptr = plan["win_ptr"]
    assert ptr.shape == (s.n_windows + 1,) and ptr[-1] == s.n_steps
    for w in range(s.n_windows):
        assert np.all(s.win_id[ptr[w]:ptr[w + 1]] == w)
    epi_ptr, epi_slot = plan["epi_ptr"], plan["epi_slot"]
    assert epi_ptr[-1] == epi_slot.size == int((s.row_map >= 0).sum())
    for row in range(s.shape[0]):
        slots = epi_slot[epi_ptr[row]:epi_ptr[row + 1]]
        assert np.all(s.row_map[slots] == row) and np.all(np.diff(slots) > 0)
    shuffled = tsched.Schedule(**{**s.__dict__, "win_id": s.win_id[::-1].copy()})
    with pytest.raises(ValueError, match="two step runs"):
        spmm_cuda.kernel_plan(shuffled)


def test_plain_window_and_epilogue_with_unperm():
    ta, _, b = _case(120, 0.05, 0.9, 7, 3)
    s = tsched.build_balanced_schedule(ta, 16, 8, evil_threshold=8)
    steps = texe.device_step_arrays(s, "cpu")
    tb = torch.from_numpy(b)
    out_perm = spmm_cuda.spmm_window(steps, tb)
    assert out_perm.dtype == torch.float32
    assert out_perm.shape == (s.n_windows * 8, 7)
    assert torch.all(out_perm[torch.from_numpy(s.row_map) < 0] == 0)
    inv = torch.from_numpy(np.random.default_rng(3).permutation(120).astype(np.int32))
    full = spmm_cuda.spmm_epilogue(steps, out_perm, torch.float32)
    unp = spmm_cuda.spmm_epilogue(steps, out_perm, torch.bfloat16, inv)
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
