"""The measured autotune loop (paper Fig. 17/18, wall-clock objective).

``autotune`` sweeps the candidate space from ``tuning.space``, prunes
obviously-unbalanced candidates with the paper's cycle model
(``core.autotuner.converged_utilization`` — §IV's converged configuration
sets the achievable-cycles floor) extended with a gather-locality estimate
(``core.reorder.schedule_locality`` — a row remapping whose locality does
not beat the identity order cannot pay for itself and is skipped before
timing), measures each survivor's jitted device-resident executor on a
random probe operand, attaches an f32-vs-bf16 max-error report to the
winner, and caches it — in-process by graph fingerprint, and on disk
through a ``tuning.store.TuningStore`` when one is passed (reorder winners
persist their row permutation alongside the schedule), so the *next
process* skips the sweep entirely.

The port of ``repro.tuning.runner``: candidates run on ``device`` (default:
the card), through the hand-written kernels there, and are timed on the
host clock with the device synchronized on both sides (``time_call``). A
sharded candidate (``n_devices``) runs over the first ``n_devices``
positions of ``mesh`` (a list of devices; default: the first CUDA devices).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

import torch

from repro_torch.core import autotuner
from repro_torch.core import csc as fmt
from repro_torch.core import reorder as _reorder
from repro_torch.core.executor import (
    ONEHOT,
    ScheduleExecutor,
    ShardedScheduleExecutor,
    _ExecutorBase,
)
from repro_torch.device import resolve_device, resolve_mesh
from repro_torch.tuning import registry
from repro_torch.tuning.space import (
    TunedConfig,
    candidate_executor_kwargs,
    default_sweep,
    sharded_device_counts,
    sharded_sweep,
)
from repro_torch.tuning.store import (
    TuningStore,
    device_count,
    device_kind,
    mesh_descriptor,
)

_AUTOTUNE_CACHE: dict = {}

#: pruning slack: a candidate is timed unless its locality-scaled cost
#: exceeds ``slack ×`` the larger of (best candidate's cost, the
#: paper-model converged-cycles floor). Generous by design — the pruner
#: must only drop *obviously*-unbalanced points, never the measured winner.
PRUNE_SLACK = 4.0

#: the §IV design the cycle-model floor runs: 1-hop smoothing + remote
#: switching + evil-row remapping (design "C" — what converged hardware
#: achieves without dataset-specific hop tuning).
PRUNE_DESIGN = autotuner.DesignConfig(
    "prune", smoothing_hops=1, remote_switching=True, row_remapping=True
)


#: measurement rounds per ``autotune`` — every candidate is timed once per
#: round, interleaved, and its minimum is kept (see the loop in
#: ``autotune`` for why sequential one-shot timing is not trustworthy)
AUTOTUNE_ROUNDS = 3

#: a reordered candidate must beat the best identity-order candidate by
#: this fraction to win the sweep. Adopting a permutation is not free —
#: the engine maintains a permuted twin across graph updates, the store
#: persists the permutation, and every spmm pays the un-permute epilogue
#: — so a within-noise "win" must resolve to identity, not to whichever
#: candidate got the luckier minimum
REORDER_MARGIN = 0.02


def _sync() -> None:
    """Wait for every launched device operation (a no-op on a host whose
    process has not touched a card)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_call(
    fn: Callable[[], torch.Tensor],
    iters: int,
    warmup: int,
) -> float:
    """Mean wall-clock microseconds of ``fn`` over ``iters`` calls, after
    ``warmup`` calls. Host clock, with the device synchronized on both
    sides of the timed loop: CUDA launches return before the card finishes,
    so the clock stops only once the last call's work is done."""
    for _ in range(warmup):
        fn()
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync()
    return (time.perf_counter() - t0) / iters * 1e6


def measure_candidate(ex: _ExecutorBase, b, iters: int, warmup: int) -> float:
    """Measured microseconds per spmm of one candidate's executor. The
    seam tests intercept to prove the warm-start path runs zero sweeps."""
    return time_call(lambda: ex.spmm(b), iters, warmup)


def _locality_cost(issued: float, locality: float) -> float:
    """Cycle-model cost of one candidate: issued slots scaled by the gather
    locality estimate. Locality is distinct-lines-per-slot in [1/16, 1]; a
    slot whose line is already resident costs far less than a miss, so cost
    interpolates between half price (perfect reuse) and full price (every
    slot a distinct line). Deliberately mild — ranking reorder variants is
    the pruner's job, the measured sweep decides the winner."""
    return issued * (0.5 + 0.5 * locality)


def _dominance_key(cand: dict) -> tuple:
    """The geometry identity a reorder candidate competes against: same
    schedule geometry + routing + device count, any ktile (locality and
    issued slots do not depend on ktile)."""
    return (
        cand["nnz_per_step"],
        cand["rows_per_window"],
        str(cand["cols_per_block"]),
        cand["window_nnz"],
        cand["routing"],
        cand.get("n_devices"),
    )


def prune_sweep(
    a: fmt.COO,
    cands: List[dict],
    *,
    slack: float = PRUNE_SLACK,
    design: Optional[autotuner.DesignConfig] = None,
    fingerprint: Optional[str] = None,
    verbose: bool = True,
) -> Tuple[List[dict], int]:
    """Skip timing candidates the paper's cycle model already condemns.

    Cycles ∝ issued slots (every step is the same work; ``Schedule.
    utilization`` docs) scaled by gather locality (a resident
    cache line costs less than a miss — ``_locality_cost``). The floor is
    ``nnz / u*`` where ``u*`` is the §IV autotuner's *converged*
    utilization (``converged_utilization`` with remote switching + row
    remapping) at the PE count the best candidate's window partition
    emulates — what balanced hardware could achieve on this degree
    distribution — scaled by the sweep's best locality so a well-clustered
    sweep is not condemned against an unscaled floor. Candidates needing
    more than ``slack ×`` max(best candidate, floor) cost are obviously
    unbalanced and skipped before any jit/timing.

    Reorder candidates face one extra test: a row remapping is *hopeless*
    when its model cost (issued slots × locality) is no better than the
    matching identity-order candidate's — first-fit window packing depends
    on row order, so a permutation can win by packing fewer steps or by
    improving gather locality, but one that improves neither costs a
    permutation and buys nothing. Those are dropped without being timed.
    The pruned count is always logged — no silent caps.
    Returns (kept candidates, n_pruned).
    """
    if len(cands) <= 1:
        return cands, 0
    fp = fingerprint or registry.graph_fingerprint(a)
    issued = []
    locality = []
    for cand in cands:
        sched = registry.get_schedule(
            a,
            nnz_per_step=cand["nnz_per_step"],
            rows_per_window=cand["rows_per_window"],
            cols_per_block=cand["cols_per_block"],
            window_nnz=cand["window_nnz"],
            reorder=cand.get("reorder", "none"),
            fingerprint=fp,
        )
        issued.append(sched.issued_slots)
        locality.append(_reorder.schedule_locality(sched))

    # hopeless-permutation drop: a row remapping can win on two axes —
    # gather locality, and issued slots (first-fit window packing depends
    # on row order, so a permutation that clusters heavy rows packs fewer
    # steps). A reorder candidate whose model cost (issued × locality,
    # ``_locality_cost``) is no better than the matching identity-order
    # candidate's is dominated on both and cannot win — it costs a
    # permutation and buys nothing — so it is dropped without being timed.
    cand_cost = [
        _locality_cost(s, loc) for s, loc in zip(issued, locality)
    ]
    ident_cost = {
        _dominance_key(c): cost
        for c, cost in zip(cands, cand_cost)
        if c.get("reorder", "none") == "none"
    }
    hopeless = [
        c.get("reorder", "none") != "none"
        and _dominance_key(c) in ident_cost
        and cost >= ident_cost[_dominance_key(c)]
        for c, cost in zip(cands, cand_cost)
    ]

    m = a.shape[0]
    row = np.asarray(a.row)
    if (row == fmt.PAD_IDX).any():
        row = row[row != fmt.PAD_IDX]
    row_nnz = np.bincount(row, minlength=m).astype(np.float64)
    nnz = float(row.shape[0])

    costs = cand_cost
    best_i = int(np.argmin(costs))
    n_pe = max(1, -(-m // cands[best_i]["rows_per_window"]))
    u_star, _ = autotuner.converged_utilization(
        row_nnz, n_pe, design or PRUNE_DESIGN, n_rounds=8
    )
    floor_slots = _locality_cost(nnz / max(u_star, 1e-9), min(locality))
    threshold = slack * max(costs[best_i], floor_slots)

    kept = [
        c
        for c, cost, hop in zip(cands, costs, hopeless)
        if cost <= threshold and not hop
    ]
    n_pruned = len(cands) - len(kept)
    n_hopeless = int(sum(hopeless))
    if verbose:
        print(
            f"[autotune] cycle-model pruning: {n_pruned}/{len(cands)} "
            f"candidates skipped ({n_hopeless} locality-dominated "
            f"reorderings; converged-model floor {floor_slots:.0f} cost at "
            f"{n_pe} PEs, u*={u_star:.2f}, slack {slack:g}x, best "
            f"candidate cost {costs[best_i]:.0f})"
        )
    return kept, n_pruned


def _sweep_key(sweep: Optional[list]):
    return None if sweep is None else tuple(
        tuple(sorted(c.items())) for c in sweep
    )


def store_key(
    store: TuningStore,
    fingerprint: str,
    kdim: int,
    *,
    max_devices: Optional[int] = None,
    sweep: Optional[list] = None,
    include_onehot: bool = False,
    ktile: int = 128,
    allow_bf16: bool = False,
    revision: int = 0,
    device=None,
    mesh=None,
    **_ignored,
) -> str:
    """The on-disk key ``autotune`` files its result under.

    Non-default sweeps tune a *different* objective, so their identity is
    folded into the graph half of the key — a restricted sweep's winner
    never masquerades as the full sweep's, and an ``allow_bf16`` run's
    winner never reaches a default (f32-only) caller. ``revision`` is the
    streaming repair generation passed through to ``TuningStore.key``;
    ``device`` (default: the card) names the device kind, and ``mesh`` (a
    list of devices) the devices the sweep may span.
    Extra keyword arguments are accepted and ignored so a whole
    ``autotune``-kwargs dict can be passed through (the serving engine
    does)."""
    fp_store = fingerprint
    sk = _sweep_key(sweep)
    if sk is not None or include_onehot or ktile != 128 or allow_bf16:
        extra = hashlib.blake2b(
            repr((sk, include_onehot, ktile, allow_bf16)).encode(),
            digest_size=8,
        ).hexdigest()
        fp_store = f"{fingerprint}:{extra}"
    return store.key(
        fp_store,
        kdim,
        device=device_kind(device),
        mesh=mesh_descriptor(max_devices, device, mesh),
        revision=revision,
    )


def _winning_perm(
    a: fmt.COO, cfg: TunedConfig, fingerprint: str
) -> Optional[np.ndarray]:
    """The row permutation a store entry for ``cfg`` must carry (None for
    the identity order)."""
    if cfg.reorder == "none":
        return None
    perm, _ = registry.get_reorder(a, cfg.reorder, fingerprint=fingerprint)
    return perm


def _placed_kwargs(kw: dict, device, mesh) -> dict:
    """``get_executor`` keyword arguments that place one candidate (or
    config): on ``device``, or for a sharded one over the first
    ``n_devices`` positions of ``mesh`` (default: the first CUDA
    devices)."""
    kw = dict(kw)
    d = kw.pop("n_devices", None)
    if d is None:
        return dict(kw, device=device)
    if mesh is None:
        return dict(kw, n_devices=d)
    if d > len(mesh):
        raise ValueError(f"a candidate asks for n_devices={d} on a mesh of "
                         f"{len(mesh)} position(s)")
    return dict(kw, mesh=list(mesh)[:d])


def _bf16_report(a: fmt.COO, best: TunedConfig, b, device, mesh=None) -> TunedConfig:
    """Attach max |f32 − bf16| of the winning geometry on the probe operand
    (computed whether or not the bf16 twin won the sweep).

    The twin of the winner is a **throwaway** executor — built directly,
    never cached — so the report doesn't double the winner's resident
    footprint in the registry for every tuned graph."""
    # the winner stays in the registry (it is what gets served); its
    # opposite-precision twin is built directly and garbage-collected
    placed = _placed_kwargs(best.as_executor_kwargs(), device, mesh)
    out_base = registry.get_executor(a, **placed).spmm(b)
    sched = registry.get_schedule(a, **best.as_schedule_kwargs())
    _, inv = registry.get_reorder(a, best.reorder)
    twin_kw = dict(
        ktile=best.ktile,
        routing=best.routing,
        bf16_accumulate=not best.bf16_accumulate,
        row_unperm=inv,
    )
    if best.n_devices is None:
        twin = ScheduleExecutor(sched, device=device, **twin_kw)
    else:
        twin = ShardedScheduleExecutor(
            sched, n_devices=placed.get("n_devices"), mesh=placed.get("mesh"),
            **twin_kw)
    out_twin = twin.spmm(b)
    err = float((out_base.float() - out_twin.float()).abs().max())
    return dataclasses.replace(best, bf16_max_err=err)


def autotune(
    a: fmt.COO,
    b_shape: Tuple[int, ...],
    *,
    sweep: Optional[list] = None,
    ktile: int = 128,
    iters: int = 3,
    warmup: int = 1,
    rounds: Optional[int] = None,
    seed: int = 0,
    include_onehot: bool = False,
    max_devices: Optional[int] = None,
    prune: bool = True,
    prune_slack: float = PRUNE_SLACK,
    allow_bf16: bool = False,
    bf16_report: bool = True,
    store: Optional[TuningStore] = None,
    device=None,
    mesh=None,
) -> TunedConfig:
    """Measure the sweep's jitted executors on a random dense operand of
    ``b_shape`` and cache the fastest config by graph fingerprint.

    ``b_shape`` is (n, kdim) (only kdim matters for the cache key). Every
    single-device candidate runs on ``device`` (default: the card), every
    sharded one over the first ``n_devices`` positions of ``mesh`` (a list
    of devices; default: the first CUDA devices). One-hot candidates
    are skipped unless ``include_onehot``: off the TPU (always, in the port)
    the one-hot routing is never competitive, and on the card both routings
    run the same kernel. When the host (or ``mesh``)
    exposes more than one device the default sweep additionally measures
    the **sharded** executor at power-of-two device counts (capped by
    ``max_devices`` and by ``space.sharded_worth_it`` — a graph that fits
    one device never fields a sharded candidate); explicit ``sweep``
    candidates may carry their own ``n_devices``, ``ktile``,
    ``bf16_accumulate``, and ``reorder``.

    The default sweep includes locality **reorder** twins (degree/island
    row remapping, ``core.reorder``) of the gather geometries; the axis is
    accept-or-reject — a permutation wins only by measuring faster than
    the best identity candidate by ``REORDER_MARGIN``, and the pruner
    drops ones whose locality estimate cannot pay. Candidates are timed
    in ``rounds`` interleaved passes (default ``AUTOTUNE_ROUNDS``) and
    each keeps its minimum, so slow timing drift between candidates
    cancels instead of deciding the winner. bf16
    candidates enter the timed competition only with ``allow_bf16=True`` —
    a numerics change must be an explicit caller decision, never a
    timing-noise outcome. By default the winner's bf16 twin is evaluated
    for the ``bf16_max_err`` report only.

    ``store`` makes the result durable: a hit deserializes the winning
    config, schedule, *and row permutation* (zero sweeps, zero rebuilds —
    the restart path), a miss measures and persists. ``prune`` skips
    timing candidates the cycle model rules out (see ``prune_sweep``).
    """
    dev = resolve_device(device)
    mesh = None if mesh is None else resolve_mesh(mesh=mesh)
    n_avail = device_count(dev, mesh)
    kdim = int(b_shape[-1])
    rounds = AUTOTUNE_ROUNDS if rounds is None else max(1, int(rounds))
    fp = registry.graph_fingerprint(a)
    # every argument that can change the result is part of the key — a
    # later call with different measurement/pruning/report settings must
    # re-run, not inherit a stale answer
    key = (
        fp,
        kdim,
        ktile,
        include_onehot,
        iters,
        warmup,
        rounds,
        seed,
        _sweep_key(sweep),
        max_devices,
        str(dev),
        n_avail,
        registry.mesh_fingerprint(mesh),
        prune,
        prune_slack,
        allow_bf16,
        bf16_report,
    )
    skey = None if store is None else store_key(
        store,
        fp,
        kdim,
        max_devices=max_devices,
        sweep=sweep,
        include_onehot=include_onehot,
        ktile=ktile,
        allow_bf16=allow_bf16,
        device=dev,
        mesh=mesh,
    )
    hit = _AUTOTUNE_CACHE.get(key)
    if hit is not None:
        # an in-process hit must still leave the store populated — a second
        # engine/store on the same graph relies on it
        if store is not None and not store.path(skey).exists():
            sched = registry.get_schedule(
                a, **hit.as_schedule_kwargs(), fingerprint=fp
            )
            store.save(skey, hit, sched, _winning_perm(a, hit, fp))
        return hit

    if store is not None:
        entry = store.load(skey)
        if entry is not None:
            cfg, sched, perm = entry
            # belt and braces: the allow_bf16 key-fold already separates
            # the entries, but never hand a bf16 config to an f32 caller;
            # and a caller asking for the bf16 error report must not be
            # served a report-less entry persisted by a bf16_report=False
            # run — re-tune, attach the report, re-save
            if (
                (cfg.n_devices is None or cfg.n_devices <= n_avail)
                and (allow_bf16 or not cfg.bf16_accumulate)
                and not (bf16_report and cfg.bf16_max_err is None)
            ):
                registry.adopt_reorder(fp, cfg.reorder, perm)
                registry.adopt_schedule(fp, cfg, sched)
                _AUTOTUNE_CACHE[key] = cfg
                return cfg
            # tuned for a bigger mesh than this host exposes: re-tune

    if sweep is None:
        sweep_eff = default_sweep(a) + sharded_sweep(
            a, sharded_device_counts(max_devices, n_avail)
        )
    else:
        sweep_eff = list(sweep)

    # eligibility first, pruning second: the pruner must neither build
    # schedules for candidates that will never be timed (capped one-hot
    # builds are real work off-TPU) nor anchor its threshold to them
    on_tpu = False  # the port never runs on a TPU
    sweep_eff = [
        c
        for c in sweep_eff
        if (c["routing"] != ONEHOT or on_tpu or include_onehot)
        and (allow_bf16 or not c.get("bf16_accumulate"))
    ]
    if not sweep_eff:
        raise ValueError(
            "autotune sweep has no measurable candidate: every point was "
            "one-hot-routed and those are skipped off-TPU — pass "
            "include_onehot=True or add a gather candidate"
        )

    if prune:
        sweep_eff, _ = prune_sweep(
            a, sweep_eff, slack=prune_slack, fingerprint=fp
        )

    rng = np.random.default_rng(seed)
    b = torch.from_numpy(
        rng.standard_normal((a.shape[1], kdim)).astype(np.float32)
    ).to(dev)
    # interleaved min-of-rounds timing: measure every candidate once (with
    # its warmup), then revisit the whole field ``rounds - 1`` more
    # times and keep each candidate's minimum. Back-to-back sequential
    # timing lets slow process-level drift (allocator state, frequency
    # scaling, first-measurements-run-hot) masquerade as a candidate
    # difference; a few-percent reorder effect cannot survive that, and
    # the min over interleaved rounds cancels it. The visit order rotates
    # per round — whichever candidate runs first after a round boundary
    # measures systematically differently, and a fixed order would bake
    # that position bias into the comparison.
    timed = []
    for cand in sweep_eff:
        kw = candidate_executor_kwargs(cand, ktile)
        ex = registry.get_executor(a, **_placed_kwargs(kw, dev, mesh))
        timed.append([cand, kw, ex, measure_candidate(ex, b, iters, warmup)])
    for r in range(1, rounds):
        k = r % len(timed)
        for rec in timed[k:] + timed[:k]:
            rec[3] = min(rec[3], measure_candidate(rec[2], b, iters, 0))
    best: Optional[TunedConfig] = None
    best_eff = float("inf")
    for cand, kw, ex, us in timed:
        cfg = TunedConfig(
            nnz_per_step=cand["nnz_per_step"],
            rows_per_window=cand["rows_per_window"],
            cols_per_block=cand["cols_per_block"],
            window_nnz=cand["window_nnz"],
            ktile=kw["ktile"],
            routing=ex.routing,
            measured_us=us,
            utilization=ex.sched.utilization,
            cols_per_block_resolved=ex.sched.cols_per_block,
            n_devices=cand.get("n_devices"),
            bf16_accumulate=kw["bf16_accumulate"],
            reorder=kw["reorder"],
        )
        eff = us * (1.0 + REORDER_MARGIN if cfg.reorder != "none" else 1.0)
        if best is None or eff < best_eff:
            best, best_eff = cfg, eff
    # sweep_eff was verified non-empty and the pruner always keeps its own
    # best candidate, so at least one point was measured
    assert best is not None
    if bf16_report:
        best = _bf16_report(a, best, b, dev, mesh)
    if store is not None:
        sched = registry.get_schedule(
            a, **best.as_schedule_kwargs(), fingerprint=fp
        )
        store.save(skey, best, sched, _winning_perm(a, best, fp))
    _AUTOTUNE_CACHE[key] = best
    return best


def autotuned_executor(
    a: fmt.COO, b_shape: Tuple[int, ...], **kw
) -> _ExecutorBase:
    """The executor for the measured-fastest configuration (both the tuning
    result and the executor itself are cached), placed as ``autotune``
    placed it (``device=``, ``mesh=``)."""
    cfg = autotune(a, b_shape, **kw)
    return registry.get_executor(
        a, **_placed_kwargs(cfg.as_executor_kwargs(), kw.get("device"), kw.get("mesh"))
    )


def warm_tuned_executor(
    a: fmt.COO,
    b_shape: Tuple[int, ...],
    *,
    store: TuningStore,
    **kw,
) -> Tuple[_ExecutorBase, TunedConfig]:
    """Store-backed ``autotuned_executor``: a populated store yields the
    executor with zero measured sweeps and zero schedule rebuilds; a miss
    tunes, persists, and returns the same."""
    cfg = autotune(a, b_shape, store=store, **kw)
    ex = registry.get_executor(
        a, **_placed_kwargs(cfg.as_executor_kwargs(), kw.get("device"), kw.get("mesh"))
    )
    return ex, cfg
