"""The port's scheduling policies and placer against the JAX package's.

Two kinds of check, both on the host:

* the reference's own policy, trace and placer cases
  (``tests/test_policy.py``, ``tests/test_policy_trace.py`` and the
  ``MeshPlacer`` cases of ``tests/test_placement.py``) run again, case for
  case, with the port's classes bound in place of the reference's — a
  private copy of each reference module is loaded, so the reference's own
  tests are untouched;
* randomized scripted traces drive both packages' ``HeuristicPolicy``,
  ``LearnedServiceTimePolicy`` and ``MeshPlacer`` side by side and hold
  every decision, estimate and report equal.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.serving import placement as jplace  # noqa: E402
from repro.serving import policy as jpol  # noqa: E402
from repro_torch.serving import placement as tplace  # noqa: E402
from repro_torch.serving import policy as tpol  # noqa: E402

TESTS = Path(__file__).resolve().parent


def _reference_copy(name: str, rebind: dict):
    """A private copy of the reference test module ``name`` whose globals
    name the port's classes."""
    spec = importlib.util.spec_from_file_location(f"_port_{name}", TESTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for attr, value in rebind.items():
        assert hasattr(mod, attr), (name, attr)
        setattr(mod, attr, value)
    return mod


_POLICY_NAMES = ("GraphState", "PolicyState", "HeuristicPolicy", "LearnedServiceTimePolicy",
                 "OnlineRidge", "DispatchOrder", "ReplicaDecision", "absorb_load",
                 "GROW", "HOLD", "SHRINK", "SVC_FLOOR_S", "SVC_SAFETY")
_PLACE_NAMES = ("MeshPlacer", "Placement", "SINGLE", "SHARDED", "REPLICATED")


def _rebind(mod, names, src):
    return {n: getattr(src, n) for n in names if hasattr(mod, n)}


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_probe_{name}", TESTS / f"{name}.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    rebind = {**_rebind(probe, _POLICY_NAMES, tpol), **_rebind(probe, _PLACE_NAMES, tplace)}
    if hasattr(probe, "POL"):
        rebind["POL"] = tpol.HeuristicPolicy()
    return _reference_copy(name, rebind)


#: the reference cases that exercise the policies and the placer alone
#: (the import-path and engine cases have port versions of their own in
#: test_torch_serving_engine.py)
_CASES = {
    "test_policy": [
        "test_ridge_recovers_linear_coefficients",
        "test_ridge_regularization_shrinks_toward_zero",
        "test_ridge_theta_cache_invalidates_on_observe",
        "test_cold_start_falls_back_to_ewma",
        "test_learned_estimates_converge_to_true_service_times",
        "test_learned_model_generalizes_across_graphs",
        "test_learned_estimate_drives_shed_decision",
        "test_nonpositive_prediction_falls_back_and_counts",
        "test_reset_errors_keeps_model_but_zeroes_accuracy_window",
        "test_min_samples_validation",
    ],
    "test_policy_trace": [
        "test_place_worst_fit_and_sharded_route",
        "test_place_fuzz_matches_oracle",
        "test_replication_grow_onto_coolest_fitting_device",
        "test_replication_grow_skips_full_and_hosting_devices",
        "test_replication_respects_max_replicas_and_sharded",
        "test_replication_shrink_hysteresis_trace",
        "test_predicted_wait_serializes_colocated_edf_ahead",
        "test_predicted_wait_replicated_splits_and_sharded_spans",
        "test_shed_on_submit_boundary_and_reason",
        "test_shed_at_dispatch_matches_old_gate",
        "test_due_queues_edf_prefix_trace",
        "test_dispatch_order_edf_ties_by_graph_id",
        "test_fuzz_all_decisions_match_oracle",
        "test_absorb_load_shared_helper_matches_oracle",
    ],
    "test_placement": [
        "test_worst_fit_spreads_equal_graphs_across_devices",
        "test_bin_packing_with_lru_eviction_never_exceeds_budget",
        "test_giant_graph_routes_sharded_only_on_multi_device_mesh",
        "test_duplicate_place_or_account_rejected",
        "test_rebalance_triggers_on_concentrated_pressure_and_resets",
        "test_sharded_graph_cannot_be_moved",
        "test_replica_grow_and_shrink_accounting",
        "test_replica_candidate_requires_room_for_the_clone",
        "test_replica_unaccount_clears_every_device",
        "test_replica_invariants_rejected",
        "test_device_report_lists_replicas_per_device",
    ],
}


@pytest.mark.parametrize("module,case", [(m, c) for m, cs in _CASES.items() for c in cs])
def test_reference_case_on_the_port(module, case):
    getattr(_load(module), case)()


def test_errors_share_common_base_and_stdlib_parents():
    from repro_torch.serving.errors import (FlushError, RequestFailure, ServingError,
                                            UnknownGraphError)

    assert issubclass(UnknownGraphError, ServingError)
    assert issubclass(UnknownGraphError, KeyError)
    assert issubclass(RequestFailure, ServingError)
    assert issubclass(RequestFailure, RuntimeError)
    assert issubclass(FlushError, ServingError) and issubclass(FlushError, RuntimeError)
    e = UnknownGraphError("gid", "submit")
    assert e.graph_id == "gid" and e.op == "submit" and "gid" in str(e)


def test_submit_tickets():
    from repro_torch.serving.types import ACCEPTED, REJECTED, SHED, SubmitTicket

    t = SubmitTicket(3, ACCEPTED)
    assert t.accepted and bool(t) and t.rid == 3
    assert not SubmitTicket(None, REJECTED, "full").accepted
    assert not bool(SubmitTicket(None, SHED, "late"))


# ---------------------------------------------------------------------------
# both packages side by side over randomized scripted traces
# ---------------------------------------------------------------------------


def _states(seed: int, n: int = 60):
    """Random policy snapshots, as keyword arguments both packages take."""
    rng = np.random.default_rng(seed)
    kinds = (tplace.SINGLE, tplace.REPLICATED, tplace.SHARDED, None)
    for _ in range(n):
        n_dev = int(rng.integers(1, 5))
        budget = int(rng.integers(1, 64)) << 20
        graphs = {}
        for gi in range(int(rng.integers(1, 6))):
            kind = kinds[int(rng.integers(0, 4 if n_dev > 1 else 1))]
            if kind == tplace.SINGLE:
                dev = int(rng.integers(0, n_dev))
                devs = (dev,)
            elif kind == tplace.REPLICATED:
                devs = tuple(sorted(rng.choice(n_dev, size=min(n_dev, 2), replace=False)))
                dev = devs[0]
            elif kind == tplace.SHARDED:
                dev, devs = None, tuple(range(n_dev))
            else:
                dev, devs = None, ()
            depth = int(rng.integers(0, 6))
            graphs[f"g{gi}"] = dict(
                graph_id=f"g{gi}", nnz=int(rng.integers(1, 10**7)),
                n_rows=int(rng.integers(1, 10**5)), bytes=int(rng.integers(1, 40)) << 20,
                resident=bool(rng.random() < 0.8), kind=kind, device_index=dev,
                device_indices=tuple(int(d) for d in devs), queue_depth=depth,
                earliest_deadline=float(1000 + rng.random() * 5) if depth and rng.random() < 0.8
                else float("inf"),
                svc_ewma=float(rng.random()), svc_req_ewma=float(rng.random() / 4),
                calm_polls=int(rng.integers(0, 4)))
        yield dict(now=1000.0 + float(rng.random()), n_devices=n_dev, budget_bytes=budget,
                   used_bytes=tuple(int(rng.integers(0, 64)) << 20 for _ in range(n_dev)),
                   outstanding_s=tuple(float(rng.random()) for _ in range(n_dev)),
                   max_replicas=int(rng.integers(1, n_dev + 1)),
                   replicate_after_s=0.25, replica_shrink_after=3, max_batch=32,
                   graphs=graphs)


def _build(mod, st):
    return mod.PolicyState(**{**st, "graphs": {g: mod.GraphState(**kw)
                                               for g, kw in st["graphs"].items()}})


def _decisions(mod, pol, st, rng_seed):
    s = _build(mod, st)
    rng = np.random.default_rng(rng_seed)
    out = []
    ids = list(s.graphs)
    for gid in ids:
        out.append(dataclasses.astuple(pol.place(s, gid, int(rng.integers(1, 80)) << 20)))
        if s.graphs[gid].kind is not None:
            out.append(dataclasses.astuple(pol.replication(s, gid)))
        dl = s.now + float(rng.random() * 3)
        out.append(pol.predicted_wait(s, gid, dl))
        out.append(dataclasses.astuple(pol.shed_on_submit(s, gid, dl)))
        out.append(dataclasses.astuple(pol.shed_at_dispatch(s, gid, dl)))
    out.append(pol.due_queues(s))
    out.append(dataclasses.astuple(pol.dispatch_order(s, ids[::-1])))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_heuristic_decisions_match_reference(seed):
    for i, st in enumerate(_states(seed)):
        assert (_decisions(tpol, tpol.HeuristicPolicy(), st, i)
                == _decisions(jpol, jpol.HeuristicPolicy(), st, i))


@pytest.mark.parametrize("seed", range(4))
def test_learned_policy_matches_reference(seed):
    """The same service observations fit the same model: equal estimates,
    decisions and prediction reports at every step."""
    tp = tpol.LearnedServiceTimePolicy(min_samples=8)
    jp = jpol.LearnedServiceTimePolicy(min_samples=8)
    rng = np.random.default_rng(100 + seed)
    for i, st in enumerate(_states(seed, n=40)):
        for gid, kw in st["graphs"].items():
            b = int(rng.integers(1, 9))
            svc = float(0.002 + 0.001 * b + 1e-9 * kw["nnz"] + rng.random() * 1e-3)
            tp.observe_service(gid, b, svc, tpol.GraphState(**kw))
            jp.observe_service(gid, b, svc, jpol.GraphState(**kw))
        assert _decisions(tpol, tp, st, i) == _decisions(jpol, jp, st, i)
        assert tp.fitted == jp.fitted
        assert tp.prediction_report() == jp.prediction_report()
        if tp.fitted:
            assert np.array_equal(tp.ridge.theta, jp.ridge.theta)


@pytest.mark.parametrize("seed", range(5))
def test_placer_traces_match_reference(seed):
    """A random stream of placer operations gives the same placements,
    accounting, reports and errors in both packages."""
    rng = np.random.default_rng(seed)
    n_dev = int(rng.integers(1, 5))
    budget = 100 << 20
    tp, jp = (mod.MeshPlacer(n_dev, budget, rebalance_after=2) for mod in (tplace, jplace))
    ids = [f"g{i}" for i in range(6)]
    for _ in range(200):
        op = int(rng.integers(0, 9))
        gid = ids[int(rng.integers(0, len(ids)))]
        nbytes = int(rng.integers(1, 140)) << 20
        d = int(rng.integers(0, n_dev))
        calls = {
            0: lambda p: p.place(gid, nbytes),
            1: lambda p: p.account(gid, nbytes),
            2: lambda p: p.unaccount(gid),
            3: lambda p: p.note_eviction(gid),
            4: lambda p: p.rebalance_target(),
            5: lambda p: p.move(gid, d),
            6: lambda p: p.add_replica(gid, nbytes, device_index=d),
            7: lambda p: p.drop_replica(gid, d),
            8: lambda p: p.replica_candidate(gid, nbytes),
        }
        results = []
        for p in (tp, jp):
            try:
                r = calls[op](p)
                results.append(("ok", dataclasses.astuple(r)
                                if dataclasses.is_dataclass(r) else r))
            except (KeyError, ValueError) as e:
                results.append(("err", type(e).__name__))
        assert results[0] == results[1], (op, gid, results)
        assert tp.used == jp.used
        assert tp.device_report() == jp.device_report()
        assert ({g: dataclasses.astuple(v) for g, v in tp.placements.items()}
                == {g: dataclasses.astuple(v) for g, v in jp.placements.items()})
