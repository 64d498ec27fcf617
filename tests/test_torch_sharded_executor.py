"""The port's ``ShardedScheduleExecutor`` and its host side, against the
reference on the same numpy inputs: ``sharding.schedule_shard`` array for
array, the executor on a mesh of ``["cpu"] * D`` against the reference's sharded
executor on 8 forced host devices (run in a subprocess, as its own tests
run it), against the port's single-device executor and ``spmm_coo``, evil
rows whose chunks straddle every shard boundary, empty shards, the kernels'
plan per shard (the card path's host half, through the kernels' plain
versions), ``_from_repair``/``_value_patched`` re-uploading only dirty
shards, the registry's mesh keying and zero-transfer hit path, the
reference's validation cases, and sharded autotune candidates. Mirrors
``tests/test_sharded_executor.py``; ``tests/test_torch_shard_properties.py``
holds the hypothesis properties."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import schedule as jsched  # noqa: E402
from repro.graphs import synth as jsynth  # noqa: E402
from repro.sharding import schedule_shard as jshard  # noqa: E402
from repro_torch.core import csc as tfmt  # noqa: E402
from repro_torch.core import executor as texe  # noqa: E402
from repro_torch.core import gcn as tgcn  # noqa: E402
from repro_torch.core import profiler as tprof  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core import spmm as tspmm  # noqa: E402
from repro_torch.graphs import synth as tsynth  # noqa: E402
from repro_torch.kernels import spmm_cuda  # noqa: E402
from repro_torch.sharding import schedule_shard as tshard  # noqa: E402
from repro_torch.tuning import registry, runner, space  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
TOL = 2e-4  # tests/test_sharded_executor.py's f32 tolerance
CPU = torch.device("cpu")
DS = (1, 2, 3, 4, 8)
SCHED_KW = dict(nnz_per_step=32, rows_per_window=16)
SHARD_FIELDS = ("ranges", "val", "lrow", "lcol", "win", "cblk", "nnz")


@pytest.fixture(autouse=True)
def _fresh_caches():
    registry.clear_caches()
    yield
    registry.clear_caches()


def _graph(n=300, density=0.03, alpha=0.9, seed=7):
    return (tsynth.power_law_adjacency(n, density, alpha, seed=seed),
            jsynth.power_law_adjacency(n, density, alpha, seed=seed))


def _b(n=300, k=8, seed=0):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)


def _evil():
    """A matrix with two dense rows and sparse noise: 8-slot steps cut the
    dense rows into evil chunks that straddle every shard boundary at 2, 4
    and 8 shards (the reference's ``SCRIPT_EQUIV`` case)."""
    rng = np.random.default_rng(11)
    n = 96
    dense = np.zeros((n, n), np.float32)
    dense[5, :] = rng.standard_normal(n)
    dense[7, :] = rng.standard_normal(n)
    dense[rng.integers(0, n, 60), rng.integers(0, n, 60)] = 1.0
    return dense, rng.standard_normal((n, 5)).astype(np.float32)


def _glorot(dims, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        lim = np.sqrt(6.0 / (din + dout))
        out[f"w{i}"] = rng.uniform(-lim, lim, (din, dout)).astype(np.float32)
    return out


def _mesh(d):
    return ["cpu"] * d


# ---------------------------------------------------------------------------
# The reference on 8 forced host devices (one subprocess for the module)
# ---------------------------------------------------------------------------

REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
sys.path.insert(0, %(src)r)
sys.path.insert(0, %(tests)r)
import numpy as np, jax, jax.numpy as jnp
from repro.core import csc as fmt, executor as exe, gcn, schedule
from repro.graphs import synth
import test_torch_sharded_executor as T
assert len(jax.devices()) == 8

out = {}
a = synth.power_law_adjacency(300, 0.03, 0.9, seed=7)
b = jnp.asarray(T._b())
out["single"] = np.asarray(exe.get_executor(a, routing=exe.GATHER, **T.SCHED_KW).spmm(b))
for routing in (exe.GATHER, exe.ONEHOT):
    for reorder in ("none", "degree"):
        for d in T.DS:
            ex = exe.get_executor(a, routing=routing, n_devices=d, reorder=reorder,
                                  **T.SCHED_KW)
            assert ex.n_devices == d and ex.routing == routing
            out[f"{routing}-{reorder}-{d}"] = np.asarray(ex.spmm(b))
dense, be = T._evil()
s = schedule.build_balanced_schedule(fmt.coo_from_dense(dense), 8, 8)
for routing in (exe.GATHER, exe.ONEHOT):
    for d in (2, 4, 8):
        ex = exe.executor_for_schedule(s, n_devices=d, routing=routing)
        out[f"evil-{routing}-{d}"] = np.asarray(ex.spmm(jnp.asarray(be)))
params = {k: jnp.asarray(v) for k, v in T._glorot((8, 16, 4), 3).items()}
x = jnp.asarray(T._b(300, 8, 5))
for d in (2, 4, 8):
    out[f"forward-{d}"] = np.asarray(gcn.forward_awb(params, a, x, n_devices=d))
np.savez(sys.argv[1], **out)
print("REF OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded-ref") / "ref.npz"
    script = REF_SCRIPT % {"src": SRC, "tests": str(Path(__file__).parent)}
    r = subprocess.run([sys.executable, "-c", script, str(path)],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "REF OK" in r.stdout, \
        f"stdout:\n{r.stdout}\nstderr:\n{r.stderr[-3000:]}"
    return dict(np.load(path))


# ---------------------------------------------------------------------------
# sharding.schedule_shard against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 3, 8, 40])
def test_schedule_shard_matches_reference(d):
    ta, ja = _graph(seed=26)
    ts = tsched.build_balanced_schedule(ta, **SCHED_KW)
    js = jsched.build_balanced_schedule(ja, **SCHED_KW)
    assert np.array_equal(tshard.split_step_ranges(ts.n_steps, d),
                          jshard.split_step_ranges(js.n_steps, d))
    assert np.array_equal(tshard.shard_nnz(ts, d), jshard.shard_nnz(js, d))
    assert np.array_equal(tshard.shard_payload_bytes(ts, d),
                          jshard.shard_payload_bytes(js, d))
    t, j = tshard.shard_schedule(ts, d), jshard.shard_schedule(js, d)
    assert t.n_devices == j.n_devices == d
    assert t.steps_per_shard == j.steps_per_shard
    for f in SHARD_FIELDS:
        assert np.array_equal(getattr(t, f), getattr(j, f)), f
        assert getattr(t, f).dtype == getattr(j, f).dtype, f
    sizes = t.ranges[:, 1] - t.ranges[:, 0]
    for dev in range(d):  # trailing padding steps accumulate nothing
        assert not t.val[dev, sizes[dev]:].any()
    assert int(t.nnz.sum()) == ts.nnz


def test_profiler_shard_stats_sum_to_full_schedule():
    ta, _ = _graph(400, 0.04, 1.0, seed=25)
    s = tsched.build_balanced_schedule(ta, **SCHED_KW)
    for d in (1, 2, 5, 8):
        report = tprof.shard_report(s, d)
        assert sum(r["steps"] for r in report) == s.n_steps
        assert sum(r["nnz"] for r in report) == s.nnz
        loads = tprof.device_loads(s, d)
        assert loads.max() - loads.min() <= 1


# ---------------------------------------------------------------------------
# The executor against the reference's sharded executor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("reorder", ["none", "degree"])
@pytest.mark.parametrize("routing", ["gather", "onehot"])
def test_sharded_spmm_matches_reference(ref, routing, reorder, d):
    ta, _ = _graph()
    ex = registry.get_executor(ta, routing=routing, mesh=_mesh(d), reorder=reorder,
                               **SCHED_KW)
    assert isinstance(ex, texe.ShardedScheduleExecutor)
    assert ex.n_devices == d and ex.routing == routing and ex.device == CPU
    got = ex.spmm(torch.from_numpy(_b()))
    np.testing.assert_allclose(got.numpy(), ref[f"{routing}-{reorder}-{d}"], atol=TOL)
    np.testing.assert_allclose(got.numpy(), ref["single"], atol=TOL)


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("reorder", ["none", "degree"])
def test_kernel_plan_shards_match_reference(ref, monkeypatch, reorder, d):
    """The card's path — a kernel plan per shard, window and epilogue per
    position (the un-permutation folded into each epilogue), the ordered
    sum — through the kernels' plain versions."""
    monkeypatch.setattr(texe, "_runs_kernels", lambda device: True)
    ta, _ = _graph()
    ex = registry.get_executor(ta, mesh=_mesh(d), reorder=reorder, **SCHED_KW)
    b = torch.from_numpy(_b())
    got = ex.spmm(b)
    np.testing.assert_allclose(got.numpy(), ref[f"gather-{reorder}-{d}"], atol=TOL)
    assert torch.equal(got, ex.spmm(b))  # the ordered sum: bit-equal calls
    single = texe.ScheduleExecutor(ex.sched, device=CPU, row_unperm=ex.row_unperm)
    np.testing.assert_allclose(got.numpy(), single.spmm(b).numpy(), atol=TOL)
    ranges = ex.step_ranges
    for pos, (lo, hi) in enumerate(ranges):
        want = spmm_cuda.kernel_plan(ex.sched, np.arange(lo, hi))
        for f in spmm_cuda.DEVICE_FIELDS:
            assert np.array_equal(ex._plans[pos][f], want[f]), f
    assert ex.device_bytes == sum(s.nbytes for s in ex._steps) + (
        0 if ex.row_unperm is None else 4 * ex.sched.shape[0])


@pytest.mark.parametrize("d", (2, 4, 8))
@pytest.mark.parametrize("routing", ["gather", "onehot", "kernels"])
def test_evil_rows_straddling_shards(ref, monkeypatch, routing, d):
    """Evil-row chunks of one output row on several positions: each
    position's partial holds its share, zero elsewhere, and the sum
    reunites them."""
    if routing == "kernels":
        monkeypatch.setattr(texe, "_runs_kernels", lambda device: True)
    dense, be = _evil()
    s = tsched.build_balanced_schedule(tfmt.coo_from_dense(dense), 8, 8)
    assert s.n_evil_chunks >= 8
    evil_lo = s.n_steps - s.n_evil_chunks  # evil chunks occupy the step tail
    ranges = tshard.split_step_ranges(s.n_steps, d)
    assert int(((ranges[:, 1] > evil_lo) & (ranges[:, 0] < s.n_steps)).sum()) >= 2
    ex = registry.executor_for_schedule(
        s, mesh=_mesh(d), routing="gather" if routing == "kernels" else routing)
    got = ex.spmm(torch.from_numpy(be)).numpy()
    np.testing.assert_allclose(got, dense @ be, atol=1e-4)
    key = f"evil-{'gather' if routing == 'kernels' else routing}-{d}"
    np.testing.assert_allclose(got, ref[key], atol=TOL)


@pytest.mark.parametrize("d", (2, 4, 8))
def test_forward_matches_reference(ref, d):
    ta, _ = _graph()
    params = {k: torch.from_numpy(v) for k, v in _glorot((8, 16, 4), 3).items()}
    x = torch.from_numpy(_b(300, 8, 5))
    got = tgcn.forward_awb(params, ta, x, mesh=_mesh(d))
    np.testing.assert_allclose(got.numpy(), ref[f"forward-{d}"], atol=TOL)
    gold = tgcn.forward(params, ta, x)
    np.testing.assert_allclose(got.numpy(), gold.numpy(), atol=1e-3)
    ex = registry.get_executor(ta, mesh=_mesh(d))
    batch = ex.forward_batch(params, torch.stack([x, 0.5 * x]))
    assert torch.equal(batch[0], ex.forward(params, x))
    np.testing.assert_allclose(batch[1].numpy(), ex.forward(params, 0.5 * x).numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("routing", ["gather", "onehot", "kernels"])
def test_matches_single_device_and_coo(monkeypatch, routing):
    if routing == "kernels":
        monkeypatch.setattr(texe, "_runs_kernels", lambda device: True)
    ta, _ = _graph(seed=21)
    s = tsched.build_balanced_schedule(ta, **SCHED_KW)
    b = torch.from_numpy(_b(seed=21))
    kind = "gather" if routing == "kernels" else routing
    single = texe.ScheduleExecutor(s, routing=kind, device=CPU).spmm(b)
    np.testing.assert_allclose(single.numpy(), tspmm.spmm_coo(ta, b).numpy(), atol=1e-4)
    for d in (1, 2, 5, 8):
        ex = texe.ShardedScheduleExecutor(s, mesh=_mesh(d), routing=kind)
        np.testing.assert_allclose(ex.spmm(b).numpy(), single.numpy(), atol=TOL)
        bf16 = texe.ShardedScheduleExecutor(s, mesh=_mesh(d), routing=kind,
                                            bf16_accumulate=True)
        np.testing.assert_allclose(bf16.spmm(b).numpy(), single.numpy(), atol=0.1)


def test_empty_shards_run_nothing_and_give_zeros(monkeypatch):
    monkeypatch.setattr(texe, "_runs_kernels", lambda device: True)
    calls = []
    window = spmm_cuda.spmm_window
    monkeypatch.setattr(spmm_cuda, "spmm_window",
                        lambda steps, b, **kw: calls.append(steps) or window(steps, b, **kw))
    ta, _ = _graph(seed=3)
    s = tsched.build_balanced_schedule(ta, **SCHED_KW)
    d = s.n_steps + 5
    ex = texe.ShardedScheduleExecutor(s, mesh=_mesh(d))
    sizes = ex.step_ranges[:, 1] - ex.step_ranges[:, 0]
    assert (sizes == 0).sum() == 5
    assert all(ex._steps[i] is None for i in np.flatnonzero(sizes == 0))
    b = torch.from_numpy(_b())
    np.testing.assert_allclose(ex.spmm(b).numpy(), tspmm.spmm_coo(ta, b).numpy(),
                               atol=1e-4)
    assert len(calls) == s.n_steps  # one window per non-empty position
    # a schedule with no step at all gives zeros of the right shape
    empty = tsched.build_balanced_schedule(
        tfmt.coo_from_dense(np.zeros((6, 6), np.float32)), 8, 4)
    for kernels in (True, False):
        monkeypatch.setattr(texe, "_runs_kernels", lambda device, k=kernels: k)
        z = texe.ShardedScheduleExecutor(empty, mesh=_mesh(3)).spmm(torch.ones(6, 2))
        assert z.shape == (6, 2) and not z.any()


# ---------------------------------------------------------------------------
# Byte accounting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reorder", ["none", "degree"])
def test_gather_device_bytes_are_the_payload_model(reorder):
    ta, _ = _graph(seed=3)
    for d in (1, 2, 3, 8):
        ex = registry.get_executor(ta, routing="gather", mesh=_mesh(d), reorder=reorder,
                                   **SCHED_KW)
        unperm = 0 if ex.row_unperm is None else ex.row_unperm.nbytes
        assert ex.device_bytes == int(tshard.shard_payload_bytes(ex.sched, d).sum()) + unperm


# ---------------------------------------------------------------------------
# Streaming: only dirty shards go up again
# ---------------------------------------------------------------------------


def _repair(ts, ta, delta):
    """Apply ``delta`` to ``ta`` and repair ``ts``: (new COO, schedule,
    stats)."""
    new, rep = tfmt.apply_edge_delta(ta, delta, with_report=True)
    pro = np.bincount(tfmt.to_numpy(ta.row).astype(np.int64), minlength=ts.shape[0])
    prn = pro.copy()
    prn[rep.touched_rows] += rep.row_nnz_delta
    ns, stats = tsched.repair_schedule(ts, None, new, rep.touched_rows, per_row_old=pro,
                                       per_row_new=prn, **SCHED_KW)
    return new, ns, stats


def _move_delta(coo, rng):
    """Remove one edge and insert an absent one in the same row: the step
    count holds, so the reference's split (and its scoped path) applies."""
    row, col = tfmt.to_numpy(coo.row), tfmt.to_numpy(coo.col)
    i = int(rng.integers(row.shape[0]))
    r = int(row[i])
    c1 = int(rng.choice(np.setdiff1d(np.arange(coo.shape[1]), col[row == r])))
    return tfmt.EdgeDelta(np.array([r, r]), np.array([col[i], c1]),
                          np.array([0.0, 0.75], np.float32))


def _arrays(ex):
    if ex._kernels:
        return [[getattr(s, f) for f in spmm_cuda.DEVICE_FIELDS] if s is not None else []
                for s in ex._steps]
    return [[ex._gcol[d], ex._tgt[d], ex._val[d]] for d in range(ex.n_devices)]


def _same_as_cold(ex, cold):
    for got, want in zip(_arrays(ex), _arrays(cold)):
        assert len(got) == len(want)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("path", ["gather", "kernels"])
def test_repair_reuploads_only_dirty_shards(monkeypatch, path):
    if path == "kernels":
        monkeypatch.setattr(texe, "_runs_kernels", lambda device: True)
    ta, _ = _graph(seed=6)
    ts = tsched.build_balanced_schedule(ta, **SCHED_KW)
    ex = texe.ShardedScheduleExecutor(ts, mesh=_mesh(8), routing="gather")
    b = torch.from_numpy(_b(seed=6))
    rng = np.random.default_rng(6)
    for _ in range(5):
        ta1, ns, stats = _repair(ts, ta, _move_delta(ta, rng))
        if not stats.fell_back and ns.n_steps == ts.n_steps:
            break
    assert ns.n_steps == ts.n_steps and not stats.fell_back
    ex2 = texe.repaired_executor(ex, ns, stats)
    cold = texe.ShardedScheduleExecutor(ns, mesh=_mesh(8), routing="gather")
    _same_as_cold(ex2, cold)
    assert torch.equal(ex2.spmm(b), cold.spmm(b))
    assert 0 < ex2.dirty_devices < 8 and ex2.scoped_upload
    shared = [d for d, (o, n) in enumerate(zip(_arrays(ex), _arrays(ex2)))
              if n and all(x is y for x, y in zip(o, n))]
    assert len(shared) == 8 - ex2.dirty_devices
    # a structural delta that changes the step count: spliced per position
    # (card) or rebuilt (CPU), equal to a cold build either way
    for k in (40, 120, 360):
        big = tfmt.EdgeDelta(rng.integers(0, 300, k), rng.integers(0, 300, k),
                             (rng.random(k) + 0.1).astype(np.float32))
        _, ns2, stats2 = _repair(ns, ta1, big)
        if ns2.n_steps != ns.n_steps:
            break
    assert ns2.n_steps != ns.n_steps
    ex3 = texe.repaired_executor(ex2, ns2, stats2)
    cold3 = texe.ShardedScheduleExecutor(ns2, mesh=_mesh(8), routing="gather")
    _same_as_cold(ex3, cold3)
    assert torch.equal(ex3.spmm(b), cold3.spmm(b))
    assert ex3.device_bytes == cold3.device_bytes


@pytest.mark.parametrize("path", ["gather", "kernels"])
def test_value_patch_reuploads_only_dirty_shards(monkeypatch, path):
    if path == "kernels":
        monkeypatch.setattr(texe, "_runs_kernels", lambda device: True)
    ta, _ = _graph(seed=8)
    ts = tsched.build_balanced_schedule(ta, **SCHED_KW)
    ex = texe.ShardedScheduleExecutor(ts, mesh=_mesh(8), routing="gather")
    row, col = tfmt.to_numpy(ta.row), tfmt.to_numpy(ta.col)
    idx = np.random.default_rng(8).choice(row.shape[0], 3, replace=False)
    tp, slots = tsched.value_patch_schedule(ts, tsched.slot_entry_keys(ts), row[idx],
                                            col[idx], np.full(3, 0.375, np.float32))
    ex2 = texe.value_patched_executor(ex, tp, slots, tp.val[slots])
    cold = texe.ShardedScheduleExecutor(tp, mesh=_mesh(8), routing="gather")
    _same_as_cold(ex2, cold)
    b = torch.from_numpy(_b(seed=8))
    assert torch.equal(ex2.spmm(b), cold.spmm(b))
    touched = {int(np.searchsorted(ex.step_ranges[:, 1], s // ts.nnz_per_step,
                                   side="right")) for s in slots}
    assert ex2.scoped_upload and ex2.dirty_devices == len(touched)
    assert ex2.device_bytes == ex.device_bytes
    for d, (old, new) in enumerate(zip(_arrays(ex), _arrays(ex2))):
        if d not in touched and new:
            assert all(o is n for o, n in zip(old, new))
    # nothing touched: every upload shared
    ex3 = texe.value_patched_executor(ex2, tp, np.zeros(0, np.int64), np.zeros(0))
    assert ex3.dirty_devices == 0
    assert all(o is n for a, b2 in zip(_arrays(ex2), _arrays(ex3)) for o, n in zip(a, b2))


# ---------------------------------------------------------------------------
# Registry: mesh keying, zero transfers on a hit, validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("routing", ["gather", "onehot"])
def test_one_position_shard_matches_plain_and_coexists(routing):
    ta, _ = _graph(seed=21)
    b = torch.from_numpy(_b(seed=21))
    plain = registry.get_executor(ta, routing=routing, device="cpu", **SCHED_KW)
    sharded = registry.get_executor(ta, routing=routing, mesh=["cpu"], **SCHED_KW)
    assert isinstance(sharded, texe.ShardedScheduleExecutor) and sharded is not plain
    np.testing.assert_allclose(sharded.spmm(b).numpy(), plain.spmm(b).numpy(), atol=1e-5)
    assert registry.get_executor(ta, routing=routing, mesh=["cpu"], **SCHED_KW) is sharded


def test_mesh_keying_and_zero_transfer_hit_path(monkeypatch):
    ta, _ = _graph()
    b = torch.from_numpy(_b())
    ex2 = registry.get_executor(ta, mesh=_mesh(2))
    assert registry.get_executor(ta, mesh=_mesh(2)) is ex2
    assert registry.get_executor(ta, n_devices=2, mesh=_mesh(2)) is ex2
    ex4 = registry.get_executor(ta, mesh=_mesh(4))
    assert ex4 is not ex2
    plain = registry.get_executor(ta, device="cpu")
    assert plain is not ex2 and registry.get_executor(ta, device="cpu") is plain
    a2 = tfmt.COO(ta.row.clone(), ta.col.clone(), ta.val.clone(), ta.shape)
    assert registry.get_executor(a2, mesh=_mesh(2)) is ex2
    fp = registry.mesh_fingerprint(_mesh(2))
    assert fp == (("dev",), (2,), (("cpu", None), ("cpu", None)))
    assert registry.mesh_fingerprint(_mesh(2)) != registry.mesh_fingerprint(_mesh(4))
    assert registry.mesh_fingerprint() is None
    assert registry.device_fingerprint("cpu") == ("cpu", None)
    s = registry.get_schedule(ta)
    assert registry.executor_for_schedule(s, mesh=_mesh(2)) is \
        registry.executor_for_schedule(s, mesh=_mesh(2))
    ex2.spmm(b)
    # a hit and repeated calls never upload or plan again
    boom = lambda *a, **k: (_ for _ in ()).throw(AssertionError("upload on a hit"))  # noqa: E731
    monkeypatch.setattr(texe, "_placed", boom)
    monkeypatch.setattr(spmm_cuda, "kernel_plan", boom)
    monkeypatch.setattr(texe, "_gather_slots", boom)
    again = registry.get_executor(ta, mesh=_mesh(2))
    assert again is ex2
    first = again.spmm(b)
    for _ in range(3):
        assert torch.equal(again.spmm(b), first)


def test_sharded_executor_validates_operand_rows():
    ta, _ = _graph(seed=22)
    ex = registry.get_executor(ta, mesh=_mesh(2))
    with pytest.raises(ValueError, match="schedule expects"):
        ex.spmm(torch.zeros(ta.shape[0] + 3, 4))


def test_mesh_validation(monkeypatch):
    ta, _ = _graph(seed=23)
    s = registry.get_schedule(ta)
    n_cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="device"):  # beyond the host's cards
        registry.get_executor(ta, n_devices=n_cards + 1)
    with pytest.raises(ValueError, match="device"):
        texe.ShardedScheduleExecutor(s, n_devices=n_cards + 1)
    with pytest.raises(ValueError, match="contradicts"):
        registry.get_executor(ta, n_devices=2, mesh=["cpu"])
    with pytest.raises(ValueError, match="contradicts"):
        texe.ShardedScheduleExecutor(s, n_devices=3, mesh=_mesh(2))
    assert isinstance(texe.ShardedScheduleExecutor(s, n_devices=2, mesh=_mesh(2)),
                      texe.ShardedScheduleExecutor)
    with pytest.raises(ValueError, match="1-D"):
        texe.ShardedScheduleExecutor(s, mesh=[["cpu", "cpu"], ["cpu", "cpu"]])
    with pytest.raises(ValueError, match="cannot be combined"):
        registry.get_executor(ta, mesh=_mesh(2), device="cpu")
    with pytest.raises(ValueError, match="no device"):
        texe.ShardedScheduleExecutor(s, mesh=[])
    with pytest.raises(ValueError, match="one device type"):
        texe.ShardedScheduleExecutor(s, mesh=["cpu", "meta"])
    # without a mesh, n_devices counts the cards: none on this host
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="exposes 0 CUDA"):
        texe.ShardedScheduleExecutor(s)


# ---------------------------------------------------------------------------
# Tuning: sharded candidates on a mesh
# ---------------------------------------------------------------------------


def test_sharded_sweep_and_autotune_on_a_mesh(tmp_path):
    ta, _ = _graph()
    cands = space.sharded_sweep(ta, space.sharded_device_counts(None, 8), force=True)
    assert {c["n_devices"] for c in cands} == {2, 4, 8}
    # minimum-work gate: a graph this small fields no perf-elective candidate
    assert space.sharded_sweep(ta, space.sharded_device_counts(None, 8)) == []
    assert space.sharded_device_counts(4, 8) == (2, 4)
    sweep = [dict(nnz_per_step=32, rows_per_window=16, cols_per_block=None,
                  window_nnz=None, routing="gather", n_devices=4)]
    kw = dict(sweep=sweep, iters=1, warmup=1, device="cpu", mesh=_mesh(8))
    cfg = runner.autotune(ta, (300, 8), **kw)
    assert cfg.n_devices == 4 and cfg.measured_us > 0
    # the bf16 twin of a sharded winner is sharded too
    assert cfg.bf16_max_err is not None and 0 < cfg.bf16_max_err < 0.1
    ex = runner.autotuned_executor(ta, (300, 8), **kw)
    assert isinstance(ex, texe.ShardedScheduleExecutor) and ex.n_devices == 4
    assert ex.mesh == [CPU] * 4
    with pytest.raises(ValueError, match="mesh of 2"):
        runner.autotune(ta, (300, 8), **dict(kw, mesh=_mesh(2), seed=1))
    # a store entry tuned on the mesh warm-starts on it
    from repro_torch.tuning.store import TuningStore

    store = TuningStore(tmp_path)
    ex_w, cfg_w = runner.warm_tuned_executor(ta, (300, 8), store=store, **kw)
    assert cfg_w.n_devices == 4 and ex_w.n_devices == 4
    key = runner.store_key(store, registry.graph_fingerprint(ta), 8, device="cpu",
                           mesh=_mesh(8), sweep=sweep)
    assert store.path(key).exists()
