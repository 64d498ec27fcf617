"""The port's ScheduleExecutor against ``repro.core.executor`` on the CPU:
both routing bodies, row un-permutation, the whole-GCN forward, the batched
forward against the serving engine's ``jax.vmap(ex._forward_impl)``, the
upload fault seam and operand validation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import executor as jexe  # noqa: E402
from repro.core import reorder as jreorder  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.graphs import synth as jsynth  # noqa: E402
from repro_torch.core import executor as texe  # noqa: E402
from repro_torch.core import gcn as tgcn  # noqa: E402
from repro_torch.core import reorder as treorder  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.graphs import synth as tsynth  # noqa: E402
from repro_torch.tuning import registry as treg  # noqa: E402

KW = dict(nnz_per_step=32, rows_per_window=16)


@pytest.fixture(autouse=True)
def _fresh_caches():
    treg.clear_caches()
    texe.FAULTS.clear()
    yield
    treg.clear_caches()
    texe.FAULTS.clear()


def _pair(n=300, density=0.03, alpha=0.9, seed=7):
    return (tsynth.power_law_adjacency(n, density, alpha, seed=seed),
            jsynth.power_law_adjacency(n, density, alpha, seed=seed))


def _b(n, k=12, seed=0):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)


def _params(dims, seed=0):
    rng = np.random.default_rng(seed)
    return {f"w{i}": rng.uniform(-0.3, 0.3, (a, b)).astype(np.float32)
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}


@pytest.mark.parametrize("routing", ["gather", "onehot"])
@pytest.mark.parametrize("cb,evil", [(None, None), (32, 8), ("auto", None)])
def test_routings_match_reference(routing, cb, evil):
    ta, ja = _pair(200, 0.05, 1.2, seed=3)
    kw = dict(cols_per_block=cb, evil_threshold=evil)
    ts = tsched.build_balanced_schedule(ta, 16, 8, **kw)
    js = jsched.build_balanced_schedule(ja, 16, 8, **kw)
    tex = texe.ScheduleExecutor(ts, routing=routing, device="cpu")
    jex = jexe.ScheduleExecutor(js, routing=routing)
    b = _b(200, 9, seed=3)
    want = np.asarray(jex.spmm(jnp.asarray(b)))
    np.testing.assert_allclose(tex.spmm(torch.from_numpy(b)).numpy(), want, atol=1e-4)
    assert tex.routing == jex.routing == routing
    if routing == "gather":
        assert tex.device_bytes == jex.device_bytes


def test_chunked_gather_matches_one_chunk():
    ta, _ = _pair()
    s = tsched.build_balanced_schedule(ta, **KW)
    b = torch.from_numpy(_b(300))
    one = texe.ScheduleExecutor(s, routing="gather", device="cpu").spmm(b)
    many = texe.ScheduleExecutor(s, routing="gather", slot_chunk=100, device="cpu")
    assert many._n_chunks > 1
    torch.testing.assert_close(many.spmm(b), one, atol=1e-5, rtol=0)


@pytest.mark.parametrize("strategy", ["degree", "island"])
@pytest.mark.parametrize("routing", ["gather", "onehot"])
def test_row_unperm_matches_reference(strategy, routing):
    ta, ja = _pair(300, 0.03, 0.9, seed=7)
    tperm, tinv = treorder.permutation(ta, strategy)
    jperm, jinv = jreorder.permutation(ja, strategy)
    assert np.array_equal(tperm, jperm) and np.array_equal(tinv, jinv)
    from repro_torch.core import csc as tfmt
    from repro.core import csc as jfmt

    ts = tsched.build_balanced_schedule(tfmt.permute_coo(ta, tperm), **KW)
    js = jsched.build_balanced_schedule(jfmt.permute_coo(ja, jperm), **KW)
    tex = texe.ScheduleExecutor(ts, routing=routing, row_unperm=tinv, device="cpu")
    jex = jexe.ScheduleExecutor(js, routing=routing, row_unperm=jinv)
    b = _b(300)
    np.testing.assert_allclose(tex.spmm(torch.from_numpy(b)).numpy(),
                               np.asarray(jex.spmm(jnp.asarray(b))), atol=1e-4)
    assert tex.device_bytes >= 300 * 4


@pytest.mark.parametrize("routing", ["gather", "onehot"])
def test_forward_and_forward_batch_match_vmapped_reference(routing):
    ta, ja = _pair(150, 0.04, 1.0, seed=9)
    ts = tsched.build_balanced_schedule(ta, 16, 8, evil_threshold=8)
    js = jsched.build_balanced_schedule(ja, 16, 8, evil_threshold=8)
    tex = texe.ScheduleExecutor(ts, routing=routing, device="cpu")
    jex = jexe.ScheduleExecutor(js, routing=routing)
    params = _params([20, 16, 5])
    xs = np.random.default_rng(1).random((3, 150, 20)).astype(np.float32)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = tgcn.params_from_jax(params, "cpu")
    want = np.asarray(jax.vmap(jex._forward_impl, in_axes=(None, 0))(
        jparams, jnp.asarray(xs)))
    got = tex.forward_batch(tparams, torch.from_numpy(xs))
    assert got.shape == (3, 150, 5) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    for i in range(3):
        got_i = tex.forward(tparams, torch.from_numpy(xs[i])).numpy()
        want_i = np.asarray(jex.forward(jparams, jnp.asarray(xs[i])))
        np.testing.assert_allclose(got_i, want_i, atol=1e-4)


def test_bf16_accumulate_matches_reference_on_cpu_and_raises_on_cuda():
    ta, ja = _pair(200, 0.03, 0.9, seed=2)
    ts = tsched.build_balanced_schedule(ta, **KW)
    js = jsched.build_balanced_schedule(ja, **KW)
    b = _b(200, 8, seed=2)
    got = texe.ScheduleExecutor(ts, bf16_accumulate=True, device="cpu").spmm(
        torch.from_numpy(b)).numpy()
    want = np.asarray(jexe.ScheduleExecutor(js, bf16_accumulate=True).spmm(
        jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=3e-2 * max(1.0, np.abs(want).max()))
    with pytest.raises(NotImplementedError, match="bf16_accumulate"):
        texe.ScheduleExecutor(ts, bf16_accumulate=True, device="cuda")


def test_wrong_operand_rows_raise():
    ta, _ = _pair(100, 0.05, 0.9, seed=1)
    ex = texe.ScheduleExecutor(tsched.build_balanced_schedule(ta, 16, 8), device="cpu")
    params = tgcn.params_from_jax(_params([4, 3]), "cpu")
    with pytest.raises(ValueError, match="99 rows"):
        ex.spmm(torch.zeros(99, 4))
    with pytest.raises(ValueError, match="101 rows"):
        ex.forward(params, torch.zeros(101, 4))
    with pytest.raises(ValueError, match="98 rows"):
        ex.forward_batch(params, torch.zeros(2, 98, 4))
    with pytest.raises(ValueError, match=r"\[B, n, f\]"):
        ex.forward_batch(params, torch.zeros(100, 4))


def test_gather_slots_match_reference():
    ta, ja = _pair(200, 0.05, 1.2, seed=3)
    ts = tsched.build_balanced_schedule(ta, 16, 8, cols_per_block=32, evil_threshold=8)
    js = jsched.build_balanced_schedule(ja, 16, 8, cols_per_block=32, evil_threshold=8)
    for t, j in zip(texe._gather_slots(ts), jexe._gather_slots(js)):
        assert np.array_equal(t, j)
    steps = np.array([0, 3, ts.n_steps - 1])
    for t, j in zip(texe._gather_slots_steps(ts, steps),
                    jexe._gather_slots_steps(js, steps)):
        assert np.array_equal(t, j)


def test_routing_cost_model_matches_reference():
    for k, cb, r, kt in [(256, 232965, 64, 128), (32, 256, 16, 128), (8, 32, 8, 8)]:
        assert (texe.routing_cost_model(k, cb, r, kt)
                == jexe.routing_cost_model(k, cb, r, kt))
        assert texe.select_routing(k, cb, r, kt) == jexe.select_routing(k, cb, r, kt)


def test_device_steps_memoized_and_released():
    ta, _ = _pair(100, 0.05, 0.9, seed=1)
    s = tsched.build_balanced_schedule(ta, 16, 8)
    a = texe.device_step_arrays(s, "cpu")
    assert texe.device_step_arrays(s, "cpu") is a
    assert a.n_windows == s.n_windows and a.nbytes > 0
    assert np.array_equal(a.val.numpy(), s.val.reshape(s.n_steps, 16))
    texe.release_device_steps(s, "cpu")
    assert texe.device_step_arrays(s, "cpu") is not a
    texe.release_device_steps(s)
    assert not texe._DEVICE_STEPS


def test_upload_fault_seam():
    ta, _ = _pair(100, 0.05, 0.9, seed=1)
    s = tsched.build_balanced_schedule(ta, 16, 8)
    texe.FAULTS.arm("upload", times=1)
    with pytest.raises(texe.InjectedFault):
        texe.ScheduleExecutor(s, device="cpu")
    assert texe.FAULTS.fired == [("upload", None, torch.device("cpu"))]
    ex = texe.ScheduleExecutor(s, routing="gather", device="cpu")  # disarmed
    assert ex.utilization == s.utilization
    texe.FAULTS.arm("upload", exc=MemoryError("full"), device=torch.device("cpu"))
    with pytest.raises(MemoryError):
        texe.ScheduleExecutor(s, routing="onehot", device="cpu")
