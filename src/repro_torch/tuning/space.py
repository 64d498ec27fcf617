"""The autotune candidate space and its converged artifact (``TunedConfig``).

A candidate is a plain dict with the executor-configuration axes the sweep
explores:

    nnz_per_step, rows_per_window, cols_per_block, window_nnz, routing,
    and optionally ktile, bf16_accumulate, n_devices.

``default_sweep`` spans the single-device space — the gather path at a few
step granularities, capped one-hot points with density-matched K, **ktile**
variants (the kernel's k-tile width), and **bf16-accumulate** twins of the
strongest gather geometries (ROADMAP "Autotune breadth"). ``sharded_sweep``
adds multi-device gather candidates at power-of-two device counts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np

import torch

from repro_torch.core import csc as fmt
from repro_torch.core.executor import GATHER, ONEHOT
from repro_torch.core.schedule import auto_cols_per_block

DEFAULT_KTILE = 128
#: ktile widths the sweep explores, as in the JAX package (where it is the
#: Pallas kernel's k-tile). The CUDA window kernel lays out its columns from
#: kdim and ignores ktile, so on the card the two ktile twins time the same
#: kernel; the axis stays so the sweep and its configs match the reference.
KTILE_CANDIDATES = (64, 128)


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """A measured-fastest executor configuration for one (graph, width).

    ``cols_per_block`` holds the sweep candidate's *request* verbatim
    (None | int | "auto") so ``get_executor(**as_executor_kwargs())``
    reproduces exactly the measured executor; ``cols_per_block_resolved``
    is the block width the schedule actually used. ``n_devices`` is None
    for the single-device executor and a device count for the sharded
    one (sharded candidates enter the sweep whenever the host exposes a
    multi-device mesh). ``bf16_accumulate`` selects the reduced-precision
    accumulation path; ``bf16_max_err`` reports max |f32 − bf16| of the
    winning geometry on the tuning probe (attached by the runner whether
    or not the bf16 twin won). ``reorder`` is the locality row-remapping
    strategy the sweep accepted (``"none" | "degree" | "island"``,
    ``core.reorder``); the executor un-permutes outputs so any accepted
    value is numerically invisible to callers."""

    nnz_per_step: int
    rows_per_window: int
    cols_per_block: Union[int, str, None]
    window_nnz: Optional[int]
    ktile: int
    routing: str
    measured_us: float
    utilization: float
    cols_per_block_resolved: int = 0
    n_devices: Optional[int] = None
    bf16_accumulate: bool = False
    bf16_max_err: Optional[float] = None
    reorder: str = "none"

    def as_executor_kwargs(self) -> dict:
        return dict(
            nnz_per_step=self.nnz_per_step,
            rows_per_window=self.rows_per_window,
            cols_per_block=self.cols_per_block,
            window_nnz=self.window_nnz,
            ktile=self.ktile,
            routing=self.routing,
            n_devices=self.n_devices,
            bf16_accumulate=self.bf16_accumulate,
            reorder=self.reorder,
        )

    def as_schedule_kwargs(self) -> dict:
        """The schedule-geometry subset — what ``get_schedule`` needs to
        reproduce (or cache-seed) the winning schedule."""
        return dict(
            nnz_per_step=self.nnz_per_step,
            rows_per_window=self.rows_per_window,
            cols_per_block=self.cols_per_block,
            window_nnz=self.window_nnz,
            reorder=self.reorder,
        )


def candidate_executor_kwargs(cand: dict, default_ktile: int = DEFAULT_KTILE) -> dict:
    """Normalize a sweep candidate into ``get_executor`` keyword arguments
    (optional axes fall back to their defaults)."""
    return dict(
        nnz_per_step=cand["nnz_per_step"],
        rows_per_window=cand["rows_per_window"],
        cols_per_block=cand["cols_per_block"],
        window_nnz=cand["window_nnz"],
        routing=cand["routing"],
        ktile=cand.get("ktile", default_ktile),
        bf16_accumulate=cand.get("bf16_accumulate", False),
        n_devices=cand.get("n_devices"),
        reorder=cand.get("reorder", "none"),
    )


def density_matched_k(a: fmt.COO, rows_per_window: int, cols_per_block: int) -> int:
    """nnz_per_step for a capped one-hot schedule: the expected non-zero
    count of one (rows_per_window × cols_per_block) tile, rounded to a
    power of two ≥ 8 — each (window, block) step then carries ~K real
    slots instead of fragmenting."""
    m, n = a.shape
    nnz = int(a.row.shape[0])
    expect = max(1.0, nnz / m * rows_per_window * cols_per_block / n)
    return max(8, int(2 ** np.round(np.log2(expect))))


def default_sweep(
    a: fmt.COO,
    rows_per_window=(32, 64),
    ktiles=KTILE_CANDIDATES,
    include_bf16: bool = True,
) -> list:
    """Single-device candidate points.

    Gather-path geometries at a few step granularities × the ktile axis,
    bf16-accumulate twins of every widest-ktile gather point, locality
    **reorder** twins (``core.reorder``: degree / island row remapping —
    the cycle-model pruner drops the ones whose gather locality does not
    beat the identity order before anything is timed), plus capped one-hot
    points whose nnz_per_step is density-matched
    (≈ nnz/m · r · cb / n rounded to a lane multiple)."""
    m, n = a.shape
    cand = []
    for k in (128, 256):
        for r in rows_per_window:
            for kt in ktiles:
                cand.append(
                    dict(
                        nnz_per_step=k,
                        rows_per_window=r,
                        cols_per_block=None,
                        window_nnz=None,
                        routing=GATHER,
                        ktile=kt,
                    )
                )
            if include_bf16:
                cand.append(
                    dict(
                        nnz_per_step=k,
                        rows_per_window=r,
                        cols_per_block=None,
                        window_nnz=None,
                        routing=GATHER,
                        ktile=max(ktiles),
                        bf16_accumulate=True,
                    )
                )
            for strat in ("degree", "island"):
                cand.append(
                    dict(
                        nnz_per_step=k,
                        rows_per_window=r,
                        cols_per_block=None,
                        window_nnz=None,
                        routing=GATHER,
                        ktile=max(ktiles),
                        reorder=strat,
                    )
                )
    cb = auto_cols_per_block(n)
    if cb < n:
        for r in rows_per_window:
            cand.append(
                dict(
                    nnz_per_step=density_matched_k(a, r, cb),
                    rows_per_window=r,
                    cols_per_block="auto",
                    window_nnz=None,
                    routing=ONEHOT,
                )
            )
    return cand


#: minimum-work thresholds below which a sharded candidate cannot win: the
#: psum of [m, kdim] partials plus per-device dispatch overhead dwarfs the
#: saved gather work on small graphs (BENCH_spmm.json's
#: ``sharded_spmm/powerlaw3000`` ran at 0.06–0.23× of single-device at 35K
#: nnz before this gate existed).
MIN_SHARDED_NNZ = 200_000
MIN_SHARDED_STEPS_PER_DEVICE = 64


def sharded_worth_it(a: fmt.COO, n_devices: int, nnz_per_step: int = 256) -> bool:
    """Whether a sharded candidate at ``n_devices`` clears the minimum-work
    thresholds for this graph: enough total nnz that the cross-device psum
    can pay for itself, and enough schedule steps that every device gets a
    meaningful shard. Perf-elective sharding (the autotune sweep) consults
    this; *byte-forced* sharding — a graph that simply does not fit one
    device's budget — must not (and does not)."""
    row = fmt.to_numpy(a.row)
    nnz = int(np.count_nonzero(row != fmt.PAD_IDX))
    if nnz < MIN_SHARDED_NNZ:
        return False
    steps = -(-nnz // nnz_per_step)
    return steps >= n_devices * MIN_SHARDED_STEPS_PER_DEVICE


def sharded_device_counts(max_devices: Optional[int] = None,
                          n_avail: Optional[int] = None) -> Tuple[int, ...]:
    """Device counts the sharded sweep covers: powers of two in
    (1, available], capped at ``max_devices``, where the available count is
    ``n_avail`` (a mesh's positions) or ``torch.cuda.device_count()`` (1 on
    a host without a card). Empty on a single-device host — the sweep then
    degenerates to the single-device candidates."""
    if n_avail is None:
        n_avail = torch.cuda.device_count()
    n_avail = max(1, n_avail)
    cap = n_avail if max_devices is None else min(max_devices, n_avail)
    counts = []
    d = 2
    while d <= cap:
        counts.append(d)
        d *= 2
    return tuple(counts)


def sharded_sweep(
    a: fmt.COO, device_counts: tuple, rows_per_window=(32, 64), *, force: bool = False
) -> list:
    """Sharded-executor candidates: the gather path at each device count
    (one-hot shards identically but is never competitive off-TPU, and on
    TPU the kernel sweep covers it).

    Device counts that fail ``sharded_worth_it`` are dropped — a graph
    that fits one device never even fields a sharded candidate. ``force``
    skips that gate for byte-forced sharding (the serving engine's
    over-budget admission route, where single-device is not an option)."""
    cand = []
    for d in device_counts:
        if not force and not sharded_worth_it(a, d):
            continue
        for r in rows_per_window:
            cand.append(
                dict(
                    nnz_per_step=256,
                    rows_per_window=r,
                    cols_per_block=None,
                    window_nnz=None,
                    routing=GATHER,
                    n_devices=d,
                )
            )
    return cand
