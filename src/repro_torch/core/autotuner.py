"""The AWB-GCN runtime autotuner (paper §IV), faithful iterative version.

Reproduces the per-round rebalancing loop of the FPGA: each round (= one
output column of the column-wise-product SpMM) the Autotuner observes
per-PE finish times (PESM), then

  1. *remote switching* (§IV.B) — picks ``n_tuples`` (most-overloaded,
     most-underloaded) PE pairs at distinct crests/troughs and moves
     ``N_{i,j}`` rows between them (Eqs. 5/6, with feedback over a tracking
     window of 2 rounds),
  2. *evil row remapping* (§IV.C) — when the gap is too large for switching
     (a single row dominates the crest PE), partitions that row across
     ``n_labor`` under-loaded Labor-PEs,

while *distribution smoothing* (§IV.A) acts continuously inside the round
(modeled by ``pesim``'s h-hop interval bound).

The state after convergence — a row→PE map plus evil-row splits — is the
same object ``schedule.build_balanced_schedule`` constructs directly; the
test-suite asserts the two agree on achieved utilization. The converged
map is what the schedule lowers; the iterative path exists to reproduce the
paper's convergence dynamics (Figs. 3, 17) and per-design results (Fig. 14).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core import pesim


@dataclasses.dataclass
class DesignConfig:
    """Paper §V.B design points: Baseline, (A), (B), (C), (D)."""

    name: str
    smoothing_hops: int = 0
    remote_switching: bool = False
    row_remapping: bool = False
    n_tuples: int = 4          # switch tuples per round (Fig. 13)
    n_labor: int = 4           # labor PEs per evil-row chunk group (Fig. 13)
    evil_slack: float = 1.5    # a row is evil when even fully smoothed it
    # exceeds evil_slack × mean load — too big for switching to handle


def designs_for(dataset: str) -> Dict[str, DesignConfig]:
    """The five evaluated designs; NELL uses 2/3-hop smoothing (§V.B)."""
    lo, hi = (2, 3) if dataset == "nell" else (1, 2)
    return {
        "baseline": DesignConfig("baseline"),
        "A": DesignConfig("A", smoothing_hops=lo),
        "B": DesignConfig("B", smoothing_hops=hi),
        "C": DesignConfig("C", smoothing_hops=lo, remote_switching=True,
                          row_remapping=True),
        "D": DesignConfig("D", smoothing_hops=hi, remote_switching=True,
                          row_remapping=True),
    }


@dataclasses.dataclass
class TunerState:
    row_to_pe: np.ndarray                 # [rows] int64, -1 for split rows
    split_rows: Dict[int, Tuple[np.ndarray, np.ndarray]]
    tracked: List[Tuple[int, int, float]]  # (over_pe, under_pe, G1) feedback

    def loads(self, row_nnz: np.ndarray, n_pe: int) -> np.ndarray:
        return pesim.loads_from_assignment(row_nnz, self.row_to_pe, n_pe,
                                           self.split_rows)


@dataclasses.dataclass
class RoundLog:
    round: int
    utilization: float
    makespan: float
    n_switches: int
    n_remaps: int


def _pick_extremes(eff: np.ndarray, k: int, lowest: bool,
                   min_separation: int) -> List[int]:
    """k extreme PEs at distinct crests/troughs (the arbiter skips
    neighbours of already-selected PEs, §IV.B)."""
    order = np.argsort(eff if lowest else -eff)
    picked: List[int] = []
    for pe in order:
        if all(abs(int(pe) - p) > min_separation for p in picked):
            picked.append(int(pe))
        if len(picked) >= k:
            break
    return picked


def run_autotuning(row_nnz: np.ndarray, n_pe: int, design: DesignConfig,
                   n_rounds: int = 12, seed: int = 0,
                   ) -> Tuple[TunerState, List[RoundLog]]:
    """Simulate ``n_rounds`` of autotuning; returns converged state + log."""
    n_rows = row_nnz.shape[0]
    rng = np.random.default_rng(seed)
    state = TunerState(pesim.initial_assignment(n_rows, n_pe), {}, [])
    rows_per_pe = -(-n_rows // n_pe)
    log: List[RoundLog] = []

    # rows owned by each PE, maintained incrementally
    rows_of_pe: List[List[int]] = [[] for _ in range(n_pe)]
    for r, pe in enumerate(state.row_to_pe):
        rows_of_pe[pe].append(r)

    for rnd in range(n_rounds):
        load = state.loads(row_nnz, n_pe)
        mk = pesim.interval_makespan(load, design.smoothing_hops)
        util = float(load.sum()) / max(1e-9, n_pe * mk)
        n_sw = n_rm = 0

        if design.remote_switching or design.row_remapping:
            # crest/trough selection reads exact per-PE pending work — the
            # PESM's queue counters (smoothed estimates shift crests at
            # boundaries and can exclude the true peak)
            eff = load
            sep = 2 * design.smoothing_hops + 1
            mean_load = float(load.sum()) / n_pe
            smooth_div = 1 + 2 * design.smoothing_hops

            # --- evil row remapping first (§IV.C): rows so heavy that even
            # full smoothing leaves them above the mean are partitioned
            # across Labor-PEs at the troughs (one Super-PE group per round
            # per crest, as on the FPGA) ---------------------------------
            if design.row_remapping:
                overs = _pick_extremes(eff, design.n_tuples, False, sep)
                for over in overs:
                    own = rows_of_pe[over]
                    if not own:
                        continue
                    nnz_own = row_nnz[own]
                    heavy = int(np.argmax(nnz_own))
                    hv = float(nnz_own[heavy])
                    if hv / smooth_div <= design.evil_slack * mean_load:
                        continue
                    row = own[heavy]
                    # enough labor PEs that each chunk sinks below the mean
                    # even before smoothing (the Super-PE sizes the split
                    # from its non-zero counter)
                    n_chunks = int(min(
                        max(design.n_labor, np.ceil(hv / max(mean_load, 1.0))),
                        max(4, n_pe // 8)))
                    labor = _pick_extremes(eff, n_chunks, True, 1)
                    fr = np.full(len(labor), 1.0 / len(labor))
                    state.split_rows[row] = (np.asarray(labor), fr)
                    state.row_to_pe[row] = -1
                    own.pop(heavy)
                    n_rm += 1
                if n_rm:
                    load = state.loads(row_nnz, n_pe)
                    eff = load

            # --- remote switching, Eq. 5/6 -------------------------------
            if design.remote_switching:
                overs = _pick_extremes(eff, design.n_tuples, False, sep)
                unders = _pick_extremes(eff, design.n_tuples, True, sep)
                g1 = None
                for over, under in zip(overs, unders):
                    gap = float(load[over] - load[under])
                    if gap <= 0:
                        continue
                    if g1 is None:
                        g1 = gap  # G_1: first-tuple gap this round (Eq. 5)
                    own = rows_of_pe[over]
                    if not own:
                        continue
                    n_init = max(1, int(round(gap / max(g1, 1e-9)
                                              * max(rows_per_pe / 2, 1.0))))
                    # move rows fitting a gap/2 budget (greedy heaviest-
                    # first without overshoot, so the under-PE never turns
                    # into a new crest — the anti-thrashing rule)
                    nnz_own = row_nnz[own]
                    order = np.argsort(-nnz_own)
                    budget = gap / 2
                    moved, acc, taken = [], 0.0, 0
                    for j in order:
                        if taken >= n_init or budget - acc <= 0:
                            break
                        if float(nnz_own[j]) <= budget - acc + 1e-9:
                            moved.append(int(j))
                            acc += float(nnz_own[j])
                            taken += 1
                    for j in sorted(moved, reverse=True):
                        row = own.pop(j)
                        state.row_to_pe[row] = under
                        rows_of_pe[under].append(row)
                    if moved:
                        n_sw += 1
                        load[over] -= acc
                        load[under] += acc
                    # feedback tracking (Eq. 6)
                    state.tracked = state.tracked[-(2 * design.n_tuples):]
                    state.tracked.append((over, under, gap))

        log.append(RoundLog(rnd, util, float(mk), n_sw, n_rm))
        if (not design.remote_switching and not design.row_remapping
                and rnd >= 1):
            # static designs don't change between rounds
            for r2 in range(rnd + 1, n_rounds):
                log.append(RoundLog(r2, util, float(mk), 0, 0))
            break

    return state, log


def converged_utilization(row_nnz: np.ndarray, n_pe: int,
                          design: DesignConfig, n_rounds: int = 12
                          ) -> Tuple[float, List[RoundLog]]:
    state, log = run_autotuning(row_nnz, n_pe, design, n_rounds)
    load = state.loads(row_nnz, n_pe)
    mk = pesim.interval_makespan(load, design.smoothing_hops)
    util = float(load.sum()) / max(1e-9, n_pe * mk)
    return util, log


def total_cycles(row_nnz: np.ndarray, n_pe: int, design: DesignConfig,
                 n_output_cols: int, n_rounds: int = 12) -> float:
    """End-to-end cycles of one SpMM: the first ``n_rounds`` columns run at
    the evolving per-round makespan, the rest reuse the converged config
    ("after converging, reuses the ideal configuration")."""
    state, log = run_autotuning(row_nnz, n_pe, design, n_rounds)
    load = state.loads(row_nnz, n_pe)
    mk_conv = pesim.interval_makespan(load, design.smoothing_hops)
    warm = sum(l.makespan for l in log[:min(n_rounds, n_output_cols)])
    rest = max(0, n_output_cols - n_rounds) * mk_conv
    return warm + rest
