"""The port's tuning subsystem against ``repro.tuning`` on the CPU: the sweep,
the cycle-model pruner, store keys and entries (both ways across the two
packages), ``TunedConfig`` winners under the same deterministic timings, the
bf16 error report, and the store-backed restart path (zero sweeps, zero
rebuilds). Mirrors ``tests/test_tuning.py`` case for case where the case
exists in the port."""
import dataclasses
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import executor as jexe  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import spmm as jspmm  # noqa: E402
from repro.graphs import synth as jsynth  # noqa: E402
from repro.tuning import registry as jreg  # noqa: E402
from repro.tuning import runner as jrun  # noqa: E402
from repro.tuning import space as jspace  # noqa: E402
from repro.tuning import store as jstore  # noqa: E402
from repro_torch.core import executor as texe  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.graphs import synth as tsynth  # noqa: E402
from repro_torch.tuning import registry as treg  # noqa: E402
from repro_torch.tuning import runner as trun  # noqa: E402
from repro_torch.tuning import space as tspace  # noqa: E402
from repro_torch.tuning import store as tstore  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh_caches():
    treg.clear_caches()
    jreg.clear_caches()
    yield
    treg.clear_caches()
    jreg.clear_caches()


def _pair(n=300, density=0.03, alpha=0.9, seed=7):
    return (tsynth.power_law_adjacency(n, density, alpha, seed=seed),
            jsynth.power_law_adjacency(n, density, alpha, seed=seed))


def _b(n, k=12, seed=0):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)


def _cost(ex, b, iters, warmup):
    """Deterministic "timings" for both packages: issued slots, a hair more
    for ktile 64, more for bf16 accumulation, less for a permuted order."""
    s = ex.sched
    return (float(s.issued_slots) + (0.25 if ex.ktile == 64 else 0.0)
            + (50.0 if ex.bf16_accumulate else 0.0)
            - (0.1 * s.issued_slots if ex.row_unperm is not None else 0.0))


@pytest.fixture
def same_timings(monkeypatch):
    monkeypatch.setattr(trun, "measure_candidate", _cost)
    monkeypatch.setattr(jrun, "measure_candidate", _cost)


def _cfg(sched, **kw):
    base = dict(nnz_per_step=sched.nnz_per_step, rows_per_window=sched.rows_per_window,
                cols_per_block=None, window_nnz=None, ktile=128, routing="gather",
                measured_us=12.5, utilization=sched.utilization,
                cols_per_block_resolved=sched.cols_per_block)
    base.update(kw)
    return base


# ---------------------------------------------------------------------------
# Store: roundtrip, atomicity, corruption, key anatomy, both packages
# ---------------------------------------------------------------------------


def test_store_roundtrip(tmp_path):
    ta, _ = _pair(seed=1)
    st = tstore.TuningStore(tmp_path)
    sched = tsched.build_balanced_schedule(ta, 32, 16)
    cfg = tspace.TunedConfig(**_cfg(sched, bf16_max_err=1e-3))
    key = st.key(treg.graph_fingerprint(ta), 12, device="cpu:cpu", mesh="1dev")
    assert st.load(key) is None
    st.save(key, cfg, sched)
    got_cfg, got_sched, got_perm = st.load(key)
    assert got_perm is None
    assert got_cfg == cfg
    for f in ("win_id", "col_block", "val", "local_row", "local_col", "row_map"):
        assert np.array_equal(getattr(got_sched, f), getattr(sched, f))
    assert got_sched.shape == sched.shape
    assert got_sched.n_evil_chunks == sched.n_evil_chunks
    assert [p.name for p in st.dir.glob("*.tmp")] == []
    assert st.entries() == [key]
    assert st.nbytes() > 0


def test_store_corrupted_entry_is_a_miss(tmp_path):
    ta, _ = _pair(seed=2)
    st = tstore.TuningStore(tmp_path)
    sched = tsched.build_balanced_schedule(ta, 32, 16)
    key = st.key("fp", 8, device="cpu:cpu", mesh="1dev")
    path = st.save(key, tspace.TunedConfig(**_cfg(sched)), sched)
    path.write_bytes(b"\x00garbage" * 32)
    with pytest.warns(UserWarning, match="corrupted"):
        assert st.load(key) is None
    assert not path.exists()


def test_store_rejects_inconsistent_schedule(tmp_path):
    ta, _ = _pair(seed=3)
    st = tstore.TuningStore(tmp_path)
    sched = tsched.build_balanced_schedule(ta, 32, 16)
    key = st.key("fp2", 8, device="cpu:cpu", mesh="1dev")
    st.save(key, tspace.TunedConfig(**_cfg(sched)), sched)
    with np.load(st.path(key), allow_pickle=False) as z:
        payload = dict(z)
    payload["val"] = payload["val"][:-5]
    with open(st.path(key), "wb") as f:
        np.savez(f, **payload)
    with pytest.warns(UserWarning, match="corrupted"):
        assert st.load(key) is None


def test_store_rejects_a_bad_permutation(tmp_path):
    ta, _ = _pair(seed=3)
    st = tstore.TuningStore(tmp_path)
    sched = tsched.build_balanced_schedule(ta, 32, 16)
    cfg = tspace.TunedConfig(**_cfg(sched, reorder="degree"))
    with pytest.raises(ValueError, match="perm is missing"):
        st.save("k", cfg, sched)
    st.save("k", cfg, sched, np.zeros(300, np.int32))  # not a permutation
    with pytest.warns(UserWarning, match="corrupted"):
        assert st.load("k") is None


def test_store_key_anatomy(tmp_path):
    st = tstore.TuningStore(tmp_path)
    base = st.key("fp", 16, device="cpu:cpu", mesh="1dev")
    assert st.key("fp", 16, device="cpu:cpu", mesh="1dev") == base
    assert st.key("other", 16, device="cpu:cpu", mesh="1dev") != base
    assert st.key("fp", 32, device="cpu:cpu", mesh="1dev") != base
    assert st.key("fp", 16, device="gpu:NVIDIA H100 80GB HBM3", mesh="1dev") != base
    assert st.key("fp", 16, device="cpu:cpu", mesh="8dev") != base
    assert st.key("fp", 16, device="cpu:cpu", mesh="1dev", revision=1) != base
    assert tstore.mesh_descriptor(1, CPU) == "1dev"
    k_full = trun.store_key(st, "fp", 16, device=CPU)
    k_swp = trun.store_key(st, "fp", 16, device=CPU, sweep=[dict(
        nnz_per_step=8, rows_per_window=8, cols_per_block=None, window_nnz=None,
        routing="gather")])
    assert k_full == st.key("fp", 16, device="cpu:cpu",
                            mesh=tstore.mesh_descriptor(None, CPU))
    assert k_swp != k_full


SWEEP_1 = [dict(nnz_per_step=8, rows_per_window=8, cols_per_block=None,
                window_nnz=None, routing="gather")]


@pytest.mark.parametrize("kw", [
    {}, {"sweep": SWEEP_1}, {"allow_bf16": True}, {"ktile": 64},
    {"include_onehot": True}, {"max_devices": 1}, {"revision": 2}],
    ids=["default", "sweep", "allow_bf16", "ktile", "onehot", "max1", "revision"])
def test_store_keys_match_the_reference_on_the_cpu(tmp_path, kw):
    """The same (fingerprint, kdim, mesh) gives the same key string in both
    packages on the host: the device kind is ``cpu:cpu`` in both."""
    ta, ja = _pair(seed=5)
    fp = treg.graph_fingerprint(ta)
    assert fp == jreg.graph_fingerprint(ja)
    assert tstore.device_kind(CPU) == jstore.device_kind() == "cpu:cpu"
    assert tstore.mesh_descriptor(None, CPU) == jstore.mesh_descriptor()
    tkey = trun.store_key(tstore.TuningStore(tmp_path), fp, 16, device=CPU, **kw)
    jkey = jrun.store_key(jstore.TuningStore(tmp_path), fp, 16, **kw)
    assert tkey == jkey


def test_store_env_root(tmp_path, monkeypatch):
    monkeypatch.setenv(tstore.ENV_ROOT, str(tmp_path / "envroot"))
    assert tstore.ENV_ROOT == "REPRO_TORCH_TUNING_STORE"
    assert str(tstore.TuningStore().root) == str(tmp_path / "envroot")
    monkeypatch.delenv(tstore.ENV_ROOT)
    root = tstore.TuningStore().root
    assert root.parts[-2:] == ("repro-awb-gcn", "tuning-torch")
    assert root != jstore.default_root() or os.environ.get(jstore.ENV_ROOT)


@pytest.mark.parametrize("reorder", ["none", "island"])
def test_store_entries_load_across_packages(tmp_path, reorder):
    """A port-written entry loads in the reference's store (explicit root
    and key) and the reverse, with equal schedules and permutations; both
    packages write the same members, byte for byte."""
    ta, ja = _pair(seed=6)
    tperm, _ = treg.get_reorder(ta, reorder)
    jperm, _ = jreg.get_reorder(ja, reorder)
    ts = treg.get_schedule(ta, nnz_per_step=32, rows_per_window=16, reorder=reorder)
    js = jreg.get_schedule(ja, nnz_per_step=32, rows_per_window=16, reorder=reorder)
    cfg = _cfg(ts, reorder=reorder, bf16_max_err=0.01)
    tst, jst = tstore.TuningStore(tmp_path / "t"), jstore.TuningStore(tmp_path / "j")
    tst.save("k", tspace.TunedConfig(**cfg), ts, tperm)
    jst.save("k", jspace.TunedConfig(**cfg), js, jperm)
    with np.load(tst.path("k")) as zt, np.load(jst.path("k")) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for f in zt.files:
            assert zt[f].dtype == zj[f].dtype and zt[f].tobytes() == zj[f].tobytes(), f
    for src, dst, tuned in ((tst, jstore.TuningStore(tst.root), jspace.TunedConfig),
                            (jst, tstore.TuningStore(jst.root), tspace.TunedConfig)):
        got_cfg, got_sched, got_perm = dst.load("k")
        assert isinstance(got_cfg, tuned)
        assert dataclasses.asdict(got_cfg) == dataclasses.asdict(tspace.TunedConfig(**cfg))
        for f in ("win_id", "col_block", "val", "local_row", "local_col", "row_map"):
            assert np.array_equal(getattr(got_sched, f), getattr(ts, f))
        assert (got_perm is None) == (reorder == "none")
        if got_perm is not None:
            assert np.array_equal(got_perm, tperm)


# ---------------------------------------------------------------------------
# Sweep breadth and pruning: host artifacts equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,density,alpha,seed", [
    (600, 0.02, 0.9, 5), (300, 0.03, 0.9, 7), (2000, 0.004, 1.2, 3)])
def test_default_sweep_matches_reference(n, density, alpha, seed):
    ta, ja = _pair(n, density, alpha, seed)
    cand = tspace.default_sweep(ta)
    assert cand == jspace.default_sweep(ja)
    ktiles = {c.get("ktile") for c in cand if c["routing"] == "gather"}
    assert set(tspace.KTILE_CANDIDATES) == {64, 128} <= ktiles
    assert any(c.get("bf16_accumulate") for c in cand)
    assert any(c.get("reorder") == "island" for c in cand)
    assert tspace.density_matched_k(ta, 32, 64) == jspace.density_matched_k(ja, 32, 64)


def test_sharded_space_matches_reference():
    ta, ja = _pair(3000, 0.03, 1.0, seed=4)
    assert tspace.sharded_device_counts() == jspace.sharded_device_counts() == ()
    for d in (2, 4, 8):
        assert tspace.sharded_worth_it(ta, d) == jspace.sharded_worth_it(ja, d)
    assert (tspace.sharded_sweep(ta, (2, 4), force=True)
            == jspace.sharded_sweep(ja, (2, 4), force=True))
    cand = jspace.default_sweep(ja)[0]
    assert (tspace.candidate_executor_kwargs(cand)
            == jspace.candidate_executor_kwargs(cand))


def test_bf16_executor_matches_f32_loosely():
    ta, ja = _pair(seed=6)
    b = _b(300, seed=6)
    ref = np.asarray(jspmm.spmm_coo(ja, jnp.asarray(b)))
    ex = treg.get_executor(ta, nnz_per_step=32, rows_per_window=16,
                           bf16_accumulate=True, device=CPU)
    assert ex.bf16_accumulate
    got = ex.spmm(torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, atol=0.1)
    assert np.abs(got - ref).max() > 0
    want = np.asarray(jreg.get_executor(ja, nnz_per_step=32, rows_per_window=16,
                                        bf16_accumulate=True).spmm(jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=3e-2 * max(1.0, np.abs(want).max()))


def test_prune_skips_unbalanced_candidate_and_logs(capsys):
    ta, ja = _pair(400, 0.02, 1.1, seed=8)
    good = dict(nnz_per_step=128, rows_per_window=64, cols_per_block=None,
                window_nnz=None, routing="gather")
    bad = dict(nnz_per_step=2048, rows_per_window=8, cols_per_block=None,
               window_nnz=None, routing="gather")
    kept, n_pruned = trun.prune_sweep(ta, [good, bad])
    assert n_pruned == 1 and kept == [good]
    out = capsys.readouterr().out
    assert "1/2 candidates skipped" in out
    jrun.prune_sweep(ja, [good, bad])
    assert capsys.readouterr().out == out  # the same log line


@pytest.mark.parametrize("n,density,alpha,seed", [
    (250, 0.03, 1.0, 9), (400, 0.02, 1.0, 10), (600, 0.02, 0.9, 5),
    (1200, 0.01, 1.3, 2)])
def test_prune_sweep_matches_reference(n, density, alpha, seed):
    ta, ja = _pair(n, density, alpha, seed)
    cand = [c for c in jspace.default_sweep(ja)
            if c["routing"] == "gather" and not c.get("bf16_accumulate")]
    t_kept, t_n = trun.prune_sweep(ta, cand, verbose=False)
    j_kept, j_n = jrun.prune_sweep(ja, cand, verbose=False)
    assert t_kept == j_kept and t_n == j_n


@pytest.mark.parametrize("seed,n,density", [(9, 250, 0.03), (10, 400, 0.02)])
def test_pruner_never_discards_measured_winner(seed, n, density):
    ta, _ = _pair(n, density, 1.0, seed=seed)
    sweep = tspace.default_sweep(ta)
    cfg = trun.autotune(ta, (n, 8), sweep=sweep, iters=1, warmup=1, prune=False,
                        bf16_report=False, include_onehot=True, device=CPU)
    kept, _ = trun.prune_sweep(ta, sweep)
    winners = [c for c in kept
               if (c["nnz_per_step"], c["rows_per_window"], str(c["cols_per_block"]))
               == (cfg.nnz_per_step, cfg.rows_per_window, str(cfg.cols_per_block))
               and c["routing"] == cfg.routing]
    assert winners, (cfg, kept)


# ---------------------------------------------------------------------------
# The measured loop: winners, report, caches
# ---------------------------------------------------------------------------


def test_time_call_contract():
    calls = []
    us = trun.time_call(lambda: calls.append(1) or torch.zeros(1), iters=4, warmup=2)
    assert len(calls) == 6 and us > 0


@pytest.mark.parametrize("n,density,alpha,seed,kdim", [
    (300, 0.03, 0.9, 7, 16), (600, 0.02, 0.9, 5, 8), (400, 0.02, 1.1, 8, 12)])
def test_tuned_config_matches_reference(same_timings, n, density, alpha, seed, kdim):
    """Under the same deterministic timings both packages pick the same
    winner from the default sweep, and their bf16 reports agree."""
    ta, ja = _pair(n, density, alpha, seed)
    tcfg = trun.autotune(ta, (n, kdim), device=CPU)
    jcfg = jrun.autotune(ja, (n, kdim))
    td, jd = dataclasses.asdict(tcfg), dataclasses.asdict(jcfg)
    t_err, j_err = td.pop("bf16_max_err"), jd.pop("bf16_max_err")
    assert td == jd
    assert t_err == pytest.approx(j_err, rel=0.05, abs=1e-6)


def test_autotune_attaches_bf16_error_report():
    ta, _ = _pair(seed=7)
    cfg = trun.autotune(ta, (300, 8), iters=1, warmup=1, device=CPU)
    assert cfg.bf16_max_err is not None
    assert 0 < cfg.bf16_max_err < 0.5
    d = json.loads(json.dumps(cfg.__dict__))
    assert d["bf16_max_err"] == cfg.bf16_max_err


def test_autotune_cache_keys_on_report_and_slack():
    ta, _ = _pair(seed=18)
    cfg_no = trun.autotune(ta, (300, 8), iters=1, warmup=1, bf16_report=False,
                           device=CPU)
    assert cfg_no.bf16_max_err is None
    cfg_yes = trun.autotune(ta, (300, 8), iters=1, warmup=1, device=CPU)
    assert cfg_yes is not cfg_no and cfg_yes.bf16_max_err is not None
    assert trun.autotune(ta, (300, 8), iters=1, warmup=1, prune_slack=2.0,
                         device=CPU) is not cfg_yes
    assert trun.autotune(ta, (300, 8), iters=1, warmup=1, device=CPU) is cfg_yes


def test_store_entry_without_report_retuned_for_reporting_caller(tmp_path):
    ta, _ = _pair(seed=19)
    st = tstore.TuningStore(tmp_path)
    cfg_no = trun.autotune(ta, (300, 8), iters=1, warmup=1, bf16_report=False,
                           store=st, device=CPU)
    assert cfg_no.bf16_max_err is None
    treg.clear_caches()
    cfg = trun.autotune(ta, (300, 8), iters=1, warmup=1, store=st, device=CPU)
    assert cfg.bf16_max_err is not None
    entry_cfg, _, _ = st.load(st.entries()[0])
    assert entry_cfg.bf16_max_err is not None


def test_bf16_wins_only_with_explicit_opt_in(monkeypatch):
    ta, _ = _pair(seed=8)
    monkeypatch.setattr(trun, "measure_candidate",
                        lambda ex, b, iters, warmup: 10.0 if ex.bf16_accumulate else 100.0)
    cfg = trun.autotune(ta, (300, 8), iters=1, warmup=1, bf16_report=False, device=CPU)
    assert not cfg.bf16_accumulate
    treg.clear_caches()
    cfg2 = trun.autotune(ta, (300, 8), iters=1, warmup=1, bf16_report=False,
                         allow_bf16=True, device=CPU)
    assert cfg2.bf16_accumulate


def test_reorder_must_beat_identity_by_the_margin(monkeypatch):
    ta, _ = _pair(seed=11)
    sweep = [dict(nnz_per_step=32, rows_per_window=16, cols_per_block=None,
                  window_nnz=None, routing="gather", reorder=r)
             for r in ("none", "degree")]
    for gain, want in ((0.99, "none"), (0.95, "degree")):
        treg.clear_caches()
        monkeypatch.setattr(
            trun, "measure_candidate",
            lambda ex, b, iters, warmup, g=gain: 100.0 * (
                g if ex.row_unperm is not None else 1.0))
        cfg = trun.autotune(ta, (300, 8), sweep=sweep, prune=False,
                            bf16_report=False, device=CPU)
        assert cfg.reorder == want
    assert trun.REORDER_MARGIN == jrun.REORDER_MARGIN
    assert trun.AUTOTUNE_ROUNDS == jrun.AUTOTUNE_ROUNDS


def test_every_candidate_is_timed_in_interleaved_rounds(monkeypatch):
    ta, _ = _pair(seed=12)
    seen = []
    monkeypatch.setattr(trun, "measure_candidate",
                        lambda ex, b, iters, warmup: seen.append(
                            (ex.sched.nnz_per_step, warmup)) or 1.0)
    sweep = [dict(nnz_per_step=k, rows_per_window=16, cols_per_block=None,
                  window_nnz=None, routing="gather") for k in (16, 32, 64)]
    trun.autotune(ta, (300, 8), sweep=sweep, prune=False, bf16_report=False,
                  warmup=2, device=CPU)
    assert seen == [(16, 2), (32, 2), (64, 2), (32, 0), (64, 0), (16, 0),
                    (64, 0), (16, 0), (32, 0)]


# ---------------------------------------------------------------------------
# Store-backed autotune: the restart path
# ---------------------------------------------------------------------------


def test_autotune_store_roundtrip_zero_sweeps(tmp_path, monkeypatch):
    ta, ja = _pair(seed=12)
    st = tstore.TuningStore(tmp_path)
    cfg = trun.autotune(ta, (300, 8), iters=1, warmup=1, store=st, device=CPU)
    assert len(st.entries()) == 1
    treg.clear_caches()
    monkeypatch.setattr(trun, "measure_candidate",
                        lambda *a_, **k: pytest.fail("measured on warm path"))
    monkeypatch.setattr(tsched, "build_balanced_schedule",
                        lambda *a_, **k: pytest.fail("rebuilt on warm path"))
    ex, cfg2 = trun.warm_tuned_executor(ta, (300, 8), iters=1, warmup=1, store=st,
                                        device=CPU)
    assert cfg2 == cfg
    b = _b(300, 8, seed=12)
    np.testing.assert_allclose(ex.spmm(torch.from_numpy(b)).numpy(),
                               np.asarray(jspmm.spmm_coo(ja, jnp.asarray(b))),
                               atol=1e-4)


def test_bf16_store_entries_never_reach_f32_callers(tmp_path, monkeypatch):
    ta, _ = _pair(seed=15)
    st = tstore.TuningStore(tmp_path)
    monkeypatch.setattr(trun, "measure_candidate",
                        lambda ex, b, iters, warmup: 10.0 if ex.bf16_accumulate else 100.0)
    cfg_bf = trun.autotune(ta, (300, 8), iters=1, warmup=1, store=st, allow_bf16=True,
                           bf16_report=False, device=CPU)
    assert cfg_bf.bf16_accumulate
    treg.clear_caches()
    cfg = trun.autotune(ta, (300, 8), iters=1, warmup=1, store=st, bf16_report=False,
                        device=CPU)
    assert not cfg.bf16_accumulate
    assert len(st.entries()) == 2


def test_onehot_schedules_not_built_off_tpu(monkeypatch):
    ta, _ = _pair(600, 0.02, 0.9, seed=16)
    built = []
    orig = tsched.build_balanced_schedule

    def spy(a_, *args, **kw):
        built.append(kw.get("cols_per_block"))
        return orig(a_, *args, **kw)

    monkeypatch.setattr(tsched, "build_balanced_schedule", spy)
    trun.autotune(ta, (600, 8), iters=1, warmup=1, bf16_report=False, device=CPU)
    assert built and "auto" not in built


def test_release_graph_purges_device_step_arrays():
    ta, _ = _pair(seed=17)
    fp = treg.graph_fingerprint(ta)
    sched = treg.get_schedule(ta, nnz_per_step=16, rows_per_window=8)
    texe.device_step_arrays(sched, CPU)
    assert [k for k in texe._DEVICE_STEPS if k[0] == id(sched)]
    treg.get_executor(ta, nnz_per_step=16, rows_per_window=8, device=CPU)
    treg.release_graph(fp)
    assert not [k for k in texe._DEVICE_STEPS if k[0] == id(sched)]
    assert not [k for k in treg._SCHEDULE_CACHE if k[0] == fp]
    assert not [k for k in treg._EXECUTOR_CACHE if k[0][0] == fp]


def test_adopt_schedule_and_reorder_seed_the_caches(monkeypatch):
    ta, _ = _pair(seed=20)
    fp = treg.graph_fingerprint(ta)
    perm, _ = treg.get_reorder(ta, "island")
    sched = treg.get_schedule(ta, nnz_per_step=32, rows_per_window=16, reorder="island")
    cfg = tspace.TunedConfig(**_cfg(sched, reorder="island"))
    treg.clear_caches()
    treg.adopt_reorder(fp, "island", perm)
    treg.adopt_schedule(fp, cfg, sched)
    monkeypatch.setattr(tsched, "build_balanced_schedule",
                        lambda *a_, **k: pytest.fail("rebuilt after adoption"))
    ex = treg.get_executor(ta, **cfg.as_executor_kwargs(), device=CPU)
    assert ex.sched is sched and np.array_equal(treg.get_reorder(ta, "island")[0], perm)


def test_autotune_cache_hit_still_populates_store(tmp_path):
    ta, _ = _pair(seed=14)
    cfg = trun.autotune(ta, (300, 8), iters=1, warmup=1, device=CPU)
    st = tstore.TuningStore(tmp_path)
    cfg2 = trun.autotune(ta, (300, 8), iters=1, warmup=1, store=st, device=CPU)
    assert cfg2 is cfg
    assert len(st.entries()) == 1
    entry_cfg, _, _ = st.load(st.entries()[0])
    assert entry_cfg == cfg


def test_autotune_store_ignores_entry_for_bigger_mesh(tmp_path):
    ta, _ = _pair(seed=13)
    st = tstore.TuningStore(tmp_path)
    cfg = trun.autotune(ta, (300, 8), iters=1, warmup=1, store=st, device=CPU)
    fp = treg.graph_fingerprint(ta)
    skey = trun.store_key(st, fp, 8, device=CPU)
    sched = treg.get_schedule(ta, **cfg.as_schedule_kwargs())
    perm = trun._winning_perm(ta, cfg, fp)
    st.save(skey, dataclasses.replace(cfg, n_devices=512), sched, perm)
    treg.clear_caches()
    cfg2 = trun.autotune(ta, (300, 8), iters=1, warmup=1, store=st, device=CPU)
    assert cfg2.n_devices is None


def test_autotuned_executor_matches_coo():
    ta, ja = _pair(seed=21)
    ex = trun.autotuned_executor(ta, (300, 8), iters=1, warmup=1, bf16_report=False,
                                 device=CPU)
    b = _b(300, 8, seed=21)
    np.testing.assert_allclose(ex.spmm(torch.from_numpy(b)).numpy(),
                               np.asarray(jspmm.spmm_coo(ja, jnp.asarray(b))),
                               atol=1e-4)


def test_autotune_raises_without_a_card(monkeypatch):
    ta, _ = _pair(seed=22)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        trun.autotune(ta, (300, 8))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tstore.device_kind()


def test_onehot_candidates_need_include_onehot():
    ta, _ = _pair(seed=23)
    only_onehot = [dict(nnz_per_step=16, rows_per_window=16, cols_per_block="auto",
                        window_nnz=None, routing="onehot")]
    with pytest.raises(ValueError, match="include_onehot"):
        trun.autotune(ta, (300, 8), sweep=only_onehot, device=CPU)
    cfg = trun.autotune(ta, (300, 8), sweep=only_onehot, include_onehot=True,
                        bf16_report=False, device=CPU)
    assert cfg.routing == "onehot"


def test_schedule_serialization_validates():
    ta, _ = _pair(seed=4)
    sched = tsched.build_balanced_schedule(ta, 32, 16)
    arrays = tsched.schedule_to_arrays(sched)
    assert tsched.schedule_from_arrays(arrays).n_steps == sched.n_steps
    bad = dict(arrays)
    bad["meta"] = arrays["meta"].copy()
    bad["meta"][2] = 999
    with pytest.raises(ValueError):
        tsched.schedule_from_arrays(bad)
    assert jsched.SCHEDULE_BUILDER_VERSION == tsched.SCHEDULE_BUILDER_VERSION
    assert jstore.STORE_VERSION == tstore.STORE_VERSION
    assert jexe.GATHER == texe.GATHER
