"""Balanced SpMM schedules — the converged AWB configuration (host side).

The counterpart of ``repro.core.schedule``: the builders, repair and
serialization are the same numpy code, so every array of a ``Schedule`` is
bit-identical to the JAX package's for the same graph and geometry. Only
``scatter_epilogue`` and ``execute_schedule_torch`` (the JAX package's
``execute_schedule_jnp``) run on tensors.

What follows is the JAX package's description of the artifact.

A ``Schedule`` is the static artifact the FPGA autotuner *converges to*: a
partition of the sparse operand's non-zeros into fixed-size **steps** such
that

  * every step carries exactly ``nnz_per_step`` non-zero slots,
  * each step's output rows fall in one **window** of ``rows_per_window``
    output slots (the Pallas kernel accumulates a whole window in VMEM and
    addresses it as output block ``window_id`` — block-aligned by
    construction),
  * rows heavier than ``evil_threshold`` ("evil rows", §IV.C) are chunked
    across steps; every chunk gets a private slot in trailing windows and a
    scatter-add epilogue merges chunks into their owner rows (the Labor-PE
    adder tree). The same epilogue maps window slots back to matrix rows, so
    regular and evil output handling are unified,
  * optionally, each step's dense-operand rows fall in one column block of
    ``cols_per_block`` (paper Fig. 9 matrix blocking / TDQ-1). For
    ultra-sparse operands the default is a single block spanning all columns
    (the TDQ-2 path).

Because adjacency matrices are constant across rounds and layers (§II.A),
the schedule is built once per graph and reused — exactly the paper's
"converge, then reuse the ideal configuration".

Utilization semantics on TPU: grid steps execute sequentially on a core, so
imbalance does not idle "PEs" — it inflates *issued slots* (padding).
``utilization = nnz / issued_slots`` is therefore the exact analogue of the
paper's PE utilization: wasted slots are wasted MXU/VPU cycles.

Builders:
  * ``build_balanced_schedule`` — AWB: first-fit row windows holding
    ≤ nnz_per_step non-zeros (distribution smoothing + remote switching,
    converged) + evil-row chunking (row remapping).
  * ``build_naive_schedule`` — the paper's baseline (§III.B): uniform static
    row blocks, every block padded to the step count of the heaviest block
    (what a static-grid kernel without runtime rebalancing must issue).

Kernel contract (relied on by ``kernels/spmm_cuda.py``, which gives each
window one thread block that loops over the window's step range):
  * steps of one window are contiguous in step order, so one block owns a
    window's whole accumulator and writes it back once;
  * padding slots have ``val == 0`` and in-range local indices (0), so they
    accumulate nothing;
  * ``row_map[slot] == -1`` marks padding slots of the permuted output.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

import torch

from repro_torch.core import csc as fmt


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Static balanced execution plan for one sparse operand."""

    # per-step scalars (scalar-prefetch operands of the Pallas kernel)
    win_id: np.ndarray  # [n_steps] int32 output window of the step
    col_block: np.ndarray  # [n_steps] int32 dense-operand block id
    # packed nnz slots, length n_steps * nnz_per_step
    val: np.ndarray  # [S] float32 (0.0 in padding slots)
    local_row: np.ndarray  # [S] int32 in [0, rows_per_window)
    local_col: np.ndarray  # [S] int32 in [0, cols_per_block)
    # permuted-output → matrix-row map, length n_windows * rows_per_window;
    # -1 for unused slots. Multiple slots may map to one row (evil chunks);
    # the scatter-add epilogue is the paper's adder tree.
    row_map: np.ndarray  # [n_windows * rows_per_window] int32
    # geometry
    shape: Tuple[int, int]  # (m, n) of the sparse operand
    nnz_per_step: int
    rows_per_window: int
    cols_per_block: int
    nnz: int  # true non-zero count
    n_evil_chunks: int

    @property
    def n_steps(self) -> int:
        return int(self.win_id.shape[0])

    @property
    def n_windows(self) -> int:
        return int(self.row_map.shape[0]) // self.rows_per_window

    @property
    def issued_slots(self) -> int:
        return self.n_steps * self.nnz_per_step

    @property
    def utilization(self) -> float:
        """Fraction of issued compute slots carrying real work — the TPU
        analogue of the paper's PE utilization."""
        return self.nnz / max(1, self.issued_slots)


# ---------------------------------------------------------------------------
# Serialization — the tuning store persists converged schedules as plain
# arrays (one .npz per store entry) so serving restarts skip the rebuild.
# ---------------------------------------------------------------------------

#: bump when Schedule's on-disk layout changes — part of the store key, so
#: stale entries miss (and re-tune) instead of deserializing garbage.
SCHEDULE_FORMAT_VERSION = 1

#: bump when the *builder or repair logic* changes in a way that alters the
#: arrays a given (graph, config) pair produces — e.g. a different window
#: first-fit rule or evil-row chunking order. Entries persisted under an
#: older builder would deserialize fine (same wire format) yet disagree
#: with what ``repair_schedule`` expects to splice against, so the version
#: is folded into the store key *and* stamped into each payload: stale
#: entries miss / drop to a re-tune, never crash, never mix geometries.
SCHEDULE_BUILDER_VERSION = 1

_ARRAY_FIELDS = ("win_id", "col_block", "val", "local_row", "local_col", "row_map")


def schedule_to_arrays(sched: Schedule) -> dict:
    """Flatten a Schedule into plain numpy arrays: the six schedule arrays
    plus an int64 ``meta`` vector of the scalar geometry. The inverse of
    ``schedule_from_arrays``; together they are the store's wire format."""
    out = {f: np.asarray(getattr(sched, f)) for f in _ARRAY_FIELDS}
    out["meta"] = np.asarray(
        [
            sched.shape[0],
            sched.shape[1],
            sched.nnz_per_step,
            sched.rows_per_window,
            sched.cols_per_block,
            sched.nnz,
            sched.n_evil_chunks,
        ],
        np.int64,
    )
    return out


def schedule_from_arrays(arrays) -> Schedule:
    """Rebuild a Schedule from ``schedule_to_arrays`` output, validating
    internal consistency so a truncated or corrupted store entry raises
    ``ValueError`` (the store maps that to a re-tune) instead of producing
    an executor that silently computes garbage."""
    try:
        meta = np.asarray(arrays["meta"], np.int64)
        m, n, k, r, cb, nnz, n_evil = (int(v) for v in meta)
        fields = {f: np.asarray(arrays[f]) for f in _ARRAY_FIELDS}
    except (KeyError, TypeError, OverflowError) as e:
        raise ValueError(f"schedule entry missing/overflowing field: {e}")
    sched = Schedule(
        shape=(m, n),
        nnz_per_step=k,
        rows_per_window=r,
        cols_per_block=cb,
        nnz=nnz,
        n_evil_chunks=n_evil,
        win_id=fields["win_id"].astype(np.int32),
        col_block=fields["col_block"].astype(np.int32),
        val=fields["val"].astype(np.float32),
        local_row=fields["local_row"].astype(np.int32),
        local_col=fields["local_col"].astype(np.int32),
        row_map=fields["row_map"].astype(np.int32),
    )
    n_steps = sched.n_steps
    if (
        min(m, n, k, r, cb) <= 0
        or nnz < 0
        or n_evil < 0
        or sched.val.shape != (n_steps * k,)
        or sched.local_row.shape != (n_steps * k,)
        or sched.local_col.shape != (n_steps * k,)
        or sched.col_block.shape != (n_steps,)
        or sched.row_map.shape[0] % r != 0
        or nnz > n_steps * k
    ):
        raise ValueError("inconsistent schedule geometry in stored entry")
    # both bounds matter: a negative index would silently wrap (NumPy/jnp
    # semantics) and compute garbage instead of failing over to a re-tune
    n_colblocks = -(-n // cb)
    if n_steps and (
        int(sched.win_id.min()) < 0
        or int(sched.win_id.max()) >= sched.n_windows
        or int(sched.col_block.min(initial=0)) < 0
        or int(sched.col_block.max(initial=0)) >= n_colblocks
        or int(sched.local_row.min(initial=0)) < 0
        or int(sched.local_row.max(initial=0)) >= r
        or int(sched.local_col.min(initial=0)) < 0
        or int(sched.local_col.max(initial=0)) >= cb
        or int(sched.row_map.min(initial=-1)) < -1
        or int(sched.row_map.max(initial=-1)) >= m
    ):
        raise ValueError("out-of-range indices in stored schedule entry")
    return sched


AUTO_COLS_PER_BLOCK = 256


def auto_cols_per_block(n_cols: int, target: int = AUTO_COLS_PER_BLOCK) -> int:
    """Capped dense-operand block width for one-hot routing.

    The Pallas kernel's one-hot gather matrix is ``[K, cols_per_block]``; the
    seed default (one block spanning all ``n`` columns) makes routing work
    scale with ``K·n``. Capping at ``target`` (a couple of MXU tiles) keeps
    routing at ``K·cb`` while the block B-panel stays VMEM-resident. Operands
    narrower than the cap keep a single full-width block (TDQ-2)."""
    return n_cols if n_cols <= target else target


def _resolve_cols_per_block(n: int, cols_per_block) -> int:
    if cols_per_block is None:
        return n
    if cols_per_block == "auto":
        return auto_cols_per_block(n)
    return int(cols_per_block)


def _group_layout(keys: np.ndarray, k: int, uniform: bool):
    """Chunk sorted groups into ≤k-slot steps.

    ``keys`` must already be sorted. Returns (step_of_elem, pos_in_step,
    head_elem_of_step, n_steps). ``uniform`` pads every group to the step
    count of the heaviest group (static-baseline issue model).
    """
    ne = keys.shape[0]
    if ne == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64), 0)
    new_group = np.empty(ne, bool)
    new_group[0] = True
    np.not_equal(keys[1:], keys[:-1], out=new_group[1:])
    group_idx = np.cumsum(new_group, dtype=np.int32) - 1
    starts = np.nonzero(new_group)[0]  # [n_groups] first elem/group
    n_groups = starts.shape[0]
    pos_in_group = np.arange(ne, dtype=np.int64) - starts[group_idx]
    chunk_in_group, pos_in_chunk = np.divmod(pos_in_group, k)
    group_sizes = np.diff(np.append(starts, ne))
    group_chunks = -(-group_sizes // k)
    if uniform:
        per_group = int(group_chunks.max())
        step_of_elem = group_idx.astype(np.int64) * per_group + chunk_in_group
        n_steps = n_groups * per_group
        head_of_step = np.repeat(starts, per_group)
    else:
        chunk_offset = np.concatenate([[0], np.cumsum(group_chunks)[:-1]])
        step_of_elem = chunk_offset[group_idx] + chunk_in_group
        n_steps = int(group_chunks.sum())
        head_of_step = np.nonzero(pos_in_chunk == 0)[0]
    return step_of_elem, pos_in_chunk, head_of_step, n_steps


def _sorted_order(
    primary: np.ndarray, row: np.ndarray, col: np.ndarray, n: int
) -> np.ndarray:
    """argsort by ``(primary, row, col)``.

    Fast path: COO inputs from ``csc.coo_from_*`` are already (row, col)
    lexsorted, so one stable sort on ``primary`` yields the full order
    without the 3-key lexsort (the schedule-build hot spot on million-edge
    graphs)."""
    if row.size == 0:
        return np.zeros(0, np.int64)
    rc = row.astype(np.int64) * n + col
    if np.all(rc[1:] >= rc[:-1]):
        return np.argsort(primary, kind="stable")
    return np.lexsort((col, row, primary))


def _emit(
    row,
    col,
    val,
    shape,
    k,
    r,
    cb,
    window_of_row,
    window_start,
    evil_mask_row,
    uniform: bool,
) -> Schedule:
    """Pack non-zeros into steps obeying (window, col_block) purity.
    Regular steps first (sorted by (window, col_block)), then evil chunks."""
    m, n = shape
    n_colblocks = max(1, -(-n // cb))
    # single full-width block (the TDQ-2 default): every block id is 0, so
    # skip the per-nnz division and the key fold entirely
    one_block = n_colblocks == 1
    colblk = np.zeros(col.shape[0], np.int32) if one_block else col // cb
    is_evil = evil_mask_row[row]
    n_reg_windows = int(window_start.shape[0])

    # ---- regular rows ------------------------------------------------------
    reg = np.nonzero(~is_evil)[0]
    rwin = window_of_row[row[reg]]
    # int64 when folding in the block id: windows × n_colblocks can exceed
    # int32 on large blocked builds
    reg_key = (rwin if one_block else rwin.astype(np.int64) * n_colblocks + colblk[reg])
    order = _sorted_order(reg_key, row[reg], col[reg], n)
    reg = reg[order]
    r_step, r_pos, r_head, n_reg_steps = _group_layout(reg_key[order], k, uniform)

    # ---- evil rows: group by (row, colblock) --------------------------------
    ev = np.nonzero(is_evil)[0]
    ev_key = (
        row[ev].astype(np.int64)
        if one_block
        else row[ev].astype(np.int64) * n_colblocks + colblk[ev]
    )
    order = _sorted_order(ev_key, row[ev], col[ev], n)
    ev = ev[order]
    e_step, e_pos, e_head, n_evil_steps = _group_layout(ev_key[order], k, False)
    n_evil_chunks = n_evil_steps  # one chunk == one step == one output slot

    n_steps = max(1, n_reg_steps + n_evil_steps)
    n_evil_windows = -(-max(1, n_evil_chunks) // r) if n_evil_chunks else 0
    n_windows = max(1, n_reg_windows + n_evil_windows)

    sval = np.zeros(n_steps * k, np.float32)
    srow = np.zeros(n_steps * k, np.int32)
    scol = np.zeros(n_steps * k, np.int32)
    step_win = np.zeros(n_steps, np.int32)
    step_cb = np.zeros(n_steps, np.int32)
    row_map = np.full(n_windows * r, -1, np.int32)

    if reg.size:
        slots = r_step * k + r_pos
        sval[slots] = val[reg]
        w = window_of_row[row[reg]]
        srow[slots] = (row[reg] - window_start[w]).astype(np.int32, copy=False)
        scol[slots] = (col[reg] if one_block else col[reg] - colblk[reg] * cb).astype(
            np.int32, copy=False
        )
        head = reg[r_head]
        step_win[:n_reg_steps] = window_of_row[row[head]]
        step_cb[:n_reg_steps] = colblk[head]

    # row_map for regular windows: slot (w, j) -> window_start[w] + j while
    # within the window's row range (and not an evil row, whose value comes
    # only from chunks). One fancy-indexed write over all (window, slot)
    # pairs instead of a per-window loop.
    if n_reg_windows:
        win_end = np.concatenate(
            [window_start[1:], np.asarray([m], window_start.dtype)]
        )
        cnt = np.clip(win_end - window_start, 0, r)
        w_ids = np.repeat(np.arange(n_reg_windows, dtype=np.int64), cnt)
        j = np.arange(int(cnt.sum()), dtype=np.int64) - np.repeat(
            np.cumsum(cnt) - cnt, cnt
        )
        rows = window_start[w_ids] + j
        row_map[w_ids * r + j] = np.where(evil_mask_row[rows], -1, rows).astype(
            np.int32
        )

    if ev.size:
        slots = (n_reg_steps + e_step) * k + e_pos
        sval[slots] = val[ev]
        srow[slots] = (e_step % r).astype(np.int32)  # chunk slot in window
        scol[slots] = (col[ev] if one_block else col[ev] - colblk[ev] * cb).astype(
            np.int32
        )
        step_win[n_reg_steps:] = (n_reg_windows + e_step[e_head] // r).astype(np.int32)
        step_cb[n_reg_steps:] = colblk[ev[e_head]]
        # chunk c sits at padded slot n_reg_windows*r + c, owned by its row
        chunk_slot = n_reg_windows * r + np.arange(n_evil_chunks)
        row_map[chunk_slot] = row[ev[e_head]].astype(np.int32)

    return Schedule(
        win_id=step_win,
        col_block=step_cb,
        val=sval,
        local_row=srow,
        local_col=scol,
        row_map=row_map,
        shape=shape,
        nnz_per_step=k,
        rows_per_window=r,
        cols_per_block=cb,
        nnz=int(row.shape[0]),
        n_evil_chunks=int(n_evil_chunks),
    )


def _resolve_geometry(
    n: int, nnz_per_step: int, cols_per_block, window_nnz, evil_threshold
):
    """Shared geometry resolution for ``build_balanced_schedule`` and
    ``repair_schedule`` — both must agree or repairs stop being
    bit-identical to rebuilds."""
    cb = _resolve_cols_per_block(n, cols_per_block)
    if window_nnz is None:
        n_colblocks = -(-n // cb)
        window_nnz = (
            nnz_per_step * n_colblocks if cols_per_block == "auto" else nnz_per_step
        )
    evil_t = evil_threshold if evil_threshold is not None else window_nnz
    return cb, window_nnz, evil_t


def _window_partition(
    per_row: np.ndarray, evil_mask: np.ndarray, window_nnz: int, r: int
):
    """First-fit contiguous row windows over regular-row nnz: close a window
    when adding the next row would exceed ``window_nnz`` non-zeros, or at
    ``r`` rows. The candidate next boundary from *every* row is computed in
    one vectorized searchsorted; following the boundary chain is then O(1)
    per window. Returns ``(window_start, window_of_row)``."""
    m = per_row.shape[0]
    reg_nnz = np.where(evil_mask, 0, per_row).astype(np.int64)
    cum = np.cumsum(reg_nnz)
    if not m:
        return np.asarray([0], np.int32), np.zeros(0, np.int32)
    prev = np.concatenate([[0], cum[:-1]])
    nxt = np.searchsorted(cum, prev + window_nnz, side="right")
    idx = np.arange(m, dtype=np.int64)
    nxt = np.minimum(np.minimum(np.maximum(nxt, idx + 1), idx + r), m)
    starts = [0]
    base = int(nxt[0])
    while base < m:
        starts.append(base)
        base = int(nxt[base])
    window_start = np.asarray(starts, np.int32)
    boundary = np.zeros(m, np.int32)
    boundary[window_start[1:]] = 1
    window_of_row = np.cumsum(boundary, dtype=np.int32)
    return window_start, window_of_row


def _clean_coo(a: fmt.COO):
    row = fmt.to_numpy(a.row)
    col = fmt.to_numpy(a.col)
    val = fmt.to_numpy(a.val).astype(np.float32, copy=False)
    if (row == fmt.PAD_IDX).any():
        keep = row != fmt.PAD_IDX
        row, col, val = row[keep], col[keep], val[keep]
    # int32 indices stay int32 (million-edge builds are memory-bandwidth
    # bound); key arithmetic upcasts locally where overflow is possible.
    return row, col, val


def build_balanced_schedule(
    a: fmt.COO,
    nnz_per_step: int = 256,
    rows_per_window: int = 64,
    cols_per_block: int | None = None,
    evil_threshold: int | None = None,
    window_nnz: int | None = None,
) -> Schedule:
    """AWB schedule: first-fit contiguous row windows holding ≤ ``window_nnz``
    non-zeros and ≤ rows_per_window rows (distribution smoothing + remote
    switching, converged), evil rows chunked across steps (row remapping).

    ``cols_per_block=None`` (default) disables column blocking — right for
    ultra-sparse operands where blocking fragments steps (TDQ-2). Pass a
    block size to enable Fig.-9-style blocking (TDQ-1), or ``"auto"`` to cap
    the block at ``AUTO_COLS_PER_BLOCK`` so the kernel's one-hot routing
    cost scales with K·cb instead of K·n (see ``auto_cols_per_block``).

    ``window_nnz`` is the window's nnz budget; it defaults to
    ``nnz_per_step`` (every window drains in one full step when unblocked).
    With column blocking a window's non-zeros split across ~n_colblocks
    steps, so the budget auto-couples to ``nnz_per_step * n_colblocks`` in
    ``"auto"`` mode — each (window, block) step then still carries ~K slots
    of real work instead of fragmenting (the capped one-hot path needs a
    small ``nnz_per_step`` ≈ density·rows_per_window·cols_per_block, which
    ``executor.autotune`` selects).
    """
    m, n = a.shape
    row, col, val = _clean_coo(a)
    k, r = nnz_per_step, rows_per_window
    cb, window_nnz, evil_t = _resolve_geometry(
        n, k, cols_per_block, window_nnz, evil_threshold
    )

    per_row = np.bincount(row, minlength=m)
    evil_mask = per_row > evil_t
    window_start, window_of_row = _window_partition(per_row, evil_mask, window_nnz, r)

    return _emit(
        row,
        col,
        val,
        (m, n),
        k,
        r,
        cb,
        window_of_row,
        window_start,
        evil_mask,
        uniform=False,
    )


@dataclasses.dataclass(frozen=True)
class RepairStats:
    """What ``repair_schedule`` reused vs. re-emitted — consumed by the
    executor's scoped re-upload path and surfaced through serving stats
    and the streaming benchmark."""

    fell_back: bool  # True: answered with a full rebuild
    reason: str  # why (empty when incremental)
    win_shift: int  # new_n_reg_windows - old_n_reg_windows
    reused_reg_steps: int  # regular steps copied from the old schedule
    emitted_reg_steps: int  # regular steps re-emitted
    old_reg_steps: int
    new_reg_steps: int
    old_evil_steps: int
    new_evil_steps: int
    evil_dirty: bool  # evil section re-emitted
    windows_reused: int  # regular windows aligned old<->new & untouched
    windows_total: int
    #: per new step, the old step index whose slot payload it carries
    #: verbatim, or -1 for re-emitted steps (None when fell_back)
    step_src: np.ndarray | None = None

    @property
    def steps_reused(self) -> int:
        evil = 0 if self.evil_dirty else self.old_evil_steps
        return self.reused_reg_steps + evil


def slot_entry_keys(sched: Schedule):
    """Sorted ``row * n + col`` key of every *real* slot in the packed
    stream, plus the matching slot positions — the O(d·log nnz) lookup
    index behind value-only schedule patching.

    Every non-zero occupies exactly one slot, and its global coordinates
    reconstruct from the slot fields the same way the executor's gather
    routing derives them (``row_map`` precomposed). Padding slots reuse
    ``local_row == local_col == 0`` and so *can* alias a real (row, col)
    pair — but they always carry ``val == 0``, which is what masks them
    out here (``apply_edge_delta`` never produces explicit-zero entries,
    so a zero value identifies padding; an explicit-zero entry in a
    hand-built graph simply misses the index, and callers fall back to
    the generic repair).

    Returns ``(keys, slots)``: ``keys`` ascending (-1 entries first — the
    padding), ``slots`` the flat slot index carrying each key. Lookup:
    ``slots[np.searchsorted(keys, want)]`` after verifying the key
    matches."""
    k = sched.nnz_per_step
    r = sched.rows_per_window
    cb = sched.cols_per_block
    n = sched.shape[1]
    slot = (np.repeat(sched.win_id.astype(np.int64), k) * r + sched.local_row)
    rowg = sched.row_map[slot].astype(np.int64)
    colg = (np.repeat(sched.col_block.astype(np.int64), k) * cb + sched.local_col)
    key = np.where(sched.val != 0.0, rowg * n + colg, np.int64(-1))
    order = np.argsort(key, kind="stable")
    return key[order], order


def value_patch_schedule(sched: Schedule, index, rows, cols, vals):
    """``sched`` with the slots holding entries ``(rows[i], cols[i])``
    overwritten to ``vals[i]`` — or ``None`` when any entry is absent
    from ``index`` (caller falls back to the generic repair). ``index``
    is a ``slot_entry_keys(sched)`` result; the patched schedule is
    bit-identical to a cold ``build_balanced_schedule`` on the
    value-mutated graph because a value change never moves an entry
    between slots. Also returns the patched flat slot positions:
    ``(schedule, slots)``."""
    keys, order = index
    n = sched.shape[1]
    want = np.asarray(rows, np.int64) * n + np.asarray(cols, np.int64)
    pos = np.searchsorted(keys, want)
    if np.any(pos >= keys.size) or np.any(keys[np.minimum(pos, keys.size - 1)] != want):
        return None
    slots = order[pos]
    val = sched.val.copy()
    val[slots] = np.asarray(vals, val.dtype)
    return dataclasses.replace(sched, val=val), slots


def _rebuild_fallback(a: fmt.COO, reason: str, **kwargs):
    sched = build_balanced_schedule(a, **kwargs)
    n_reg = sched.n_steps - sched.n_evil_chunks
    return sched, RepairStats(
        fell_back=True,
        reason=reason,
        win_shift=0,
        reused_reg_steps=0,
        emitted_reg_steps=n_reg,
        old_reg_steps=0,
        new_reg_steps=n_reg,
        old_evil_steps=0,
        new_evil_steps=sched.n_evil_chunks,
        evil_dirty=True,
        windows_reused=0,
        windows_total=sched.n_windows,
    )


def repair_schedule(
    old: Schedule,
    old_coo: fmt.COO | None,
    new_coo: fmt.COO,
    touched_rows,
    *,
    nnz_per_step: int = 256,
    rows_per_window: int = 64,
    cols_per_block: int | None = None,
    evil_threshold: int | None = None,
    window_nnz: int | None = None,
    per_row_old: np.ndarray | None = None,
    per_row_new: np.ndarray | None = None,
):
    """Incrementally repair a balanced schedule after an edge delta — the
    paper's runtime rebalancing moves applied as *delta operators* instead
    of a from-scratch build.

    The three moves map onto the three phases of the repair:

    * **distribution smoothing** — the first-fit window partition is
      recomputed for the mutated nnz histogram (vectorized, O(m)), then
      *aligned* against the old partition: any window whose (start, end)
      boundaries appear in both partitions and which contains no touched
      row is provably identical (the boundary chain is deterministic in
      the prefix sums, which agree outside touched rows), so its packed
      steps carry over. Deltas only unsync the chains locally — each
      touched cluster resyncs at the next boundary both chains share.
    * **remote switching** — non-zeros of the dirty windows are re-packed
      into fresh ≤k-slot steps by one ``_emit`` over just those entries;
      reused steps merge with re-emitted steps by a stable sort on the
      (window, col_block) step key — the same global order a cold build
      produces, since a step group never spans a clean/dirty boundary.
    * **row remapping** — ``row_map`` is regenerated from the new partition
      (one O(m) fancy-indexed write); evil-row chunks are re-emitted only
      if a touched row is evil in either the old or new schedule, else the
      old chunk steps are spliced through with their window ids shifted.

    Returns ``(schedule, RepairStats)``. The result is **bit-identical** to
    ``build_balanced_schedule(new_coo, ...)`` with the same kwargs — repairs
    never fork the geometry from what a cold rebuild would produce, so
    executors, stores and replicas can treat repaired and rebuilt schedules
    interchangeably. Degenerate cases (empty graphs, partitions that no
    longer match ``old``) fall back to a full rebuild, flagged in the stats.
    """
    m, n = old.shape
    if new_coo.shape != old.shape:
        raise ValueError(
            f"edge deltas cannot change shape: {old.shape} -> {new_coo.shape}"
        )
    k, r = nnz_per_step, rows_per_window
    cb, window_nnz, evil_t = _resolve_geometry(
        n, k, cols_per_block, window_nnz, evil_threshold
    )
    if (old.nnz_per_step, old.rows_per_window, old.cols_per_block) != (k, r, cb):
        raise ValueError(
            "repair kwargs disagree with the schedule being repaired: "
            f"({old.nnz_per_step}, {old.rows_per_window}, {old.cols_per_block})"
            f" != ({k}, {r}, {cb})"
        )
    kwargs = dict(
        nnz_per_step=k,
        rows_per_window=r,
        cols_per_block=cols_per_block,
        evil_threshold=evil_threshold,
        window_nnz=window_nnz,
    )

    touched = np.unique(np.asarray(touched_rows, np.int64))
    row_n, col_n, val_n = _clean_coo(new_coo)
    if touched.size == 0:
        old_reg = old.n_steps - old.n_evil_chunks
        stats = RepairStats(
            fell_back=False,
            reason="",
            win_shift=0,
            reused_reg_steps=old_reg,
            emitted_reg_steps=0,
            old_reg_steps=old_reg,
            new_reg_steps=old_reg,
            old_evil_steps=old.n_evil_chunks,
            new_evil_steps=old.n_evil_chunks,
            evil_dirty=False,
            windows_reused=old.n_windows,
            windows_total=old.n_windows,
            step_src=np.arange(old.n_steps, dtype=np.int64),
        )
        return old, stats
    if m == 0 or old.nnz == 0 or row_n.size == 0:
        return _rebuild_fallback(new_coo, "degenerate-size", **kwargs)
    if touched.min() < 0 or touched.max() >= m:
        raise ValueError("touched_rows out of range")

    # per-row histograms: callers that track them incrementally (the serving
    # engine, via DeltaReport) skip both O(nnz) bincounts — the repair hot
    # path is then O(m + dirty_nnz) plus pure memcpy
    per_row_o = per_row_old
    if per_row_o is None:
        if old_coo is None:
            raise ValueError("need old_coo or per_row_old")
        row_o, _, _ = _clean_coo(old_coo)
        per_row_o = np.bincount(row_o, minlength=m)
    per_row_n = per_row_new
    if per_row_n is None:
        per_row_n = np.bincount(row_n, minlength=m)
    evil_o = per_row_o > evil_t
    evil_n = per_row_n > evil_t
    ws_o, _ = _window_partition(per_row_o, evil_o, window_nnz, r)
    ws_n, wor_n = _window_partition(per_row_n, evil_n, window_nnz, r)

    old_evil_w = -(-max(1, old.n_evil_chunks) // r) if old.n_evil_chunks else 0
    if (
        old.n_windows - old_evil_w != ws_o.shape[0]
        or int(old.nnz) != int(per_row_o.sum())
        or int(per_row_n.sum()) != row_n.size
    ):
        # old_coo/per_row does not describe the schedule being repaired
        return _rebuild_fallback(new_coo, "partition-mismatch", **kwargs)

    evil_dirty = bool(np.any(evil_o[touched] | evil_n[touched]))
    n_colblocks = max(1, -(-n // cb))

    # ---- window alignment: (start, end) in both partitions + untouched ----
    ends_o = np.append(ws_o[1:], m).astype(np.int64)
    ends_n = np.append(ws_n[1:], m).astype(np.int64)
    _, io, jn = np.intersect1d(ws_o, ws_n, return_indices=True)
    cand = ends_o[io] == ends_n[jn]
    t_lo = np.searchsorted(touched, ws_o[io].astype(np.int64))
    t_hi = np.searchsorted(touched, ends_o[io])
    cand &= t_hi == t_lo
    old_clean = io[cand]  # increasing, and so is its new counterpart:
    new_clean = jn[cand]  # intersect1d walks both sorted start arrays
    win_shift = int(ws_n.shape[0] - ws_o.shape[0])

    # ---- re-emit dirty windows (plus the evil section when dirty) ---------
    clean_w_n = np.zeros(ws_n.shape[0], bool)
    clean_w_n[new_clean] = True
    sel = ~clean_w_n[wor_n[row_n]] & ~evil_n[row_n]
    if evil_dirty:
        sel |= evil_n[row_n]
    idx = np.nonzero(sel)[0]  # order-preserving: subset stays (row,col)-sorted
    mid = _emit(
        row_n[idx],
        col_n[idx],
        val_n[idx],
        (m, n),
        k,
        r,
        cb,
        wor_n,
        ws_n,
        evil_n,
        uniform=False,
    )
    if idx.size:
        mid_reg = mid.n_steps - mid.n_evil_chunks
        mid_evil = mid.n_evil_chunks
    else:
        mid_reg = mid_evil = 0  # _emit pads an empty input to one no-op step

    # ---- merge reused and re-emitted regular steps ------------------------
    old_reg_steps = old.n_steps - old.n_evil_chunks
    old_win_reg = old.win_id[:old_reg_steps]
    clean_w_o = np.zeros(ws_o.shape[0], bool)
    clean_w_o[old_clean] = True
    old_keep = np.nonzero(clean_w_o[old_win_reg])[0]
    remap = np.full(ws_o.shape[0], -1, np.int64)
    remap[old_clean] = new_clean
    kept_win = remap[old_win_reg[old_keep]]
    kept_cb = old.col_block[old_keep].astype(np.int64)
    mid_win = mid.win_id[:mid_reg].astype(np.int64)
    mid_cb = mid.col_block[:mid_reg].astype(np.int64)
    if n_colblocks == 1:
        keys = np.concatenate([kept_win, mid_win])
    else:
        keys = np.concatenate(
            [kept_win * n_colblocks + kept_cb, mid_win * n_colblocks + mid_cb]
        )
    # ties never straddle sources — a (window, col_block) step group lives
    # in exactly one window, which is either wholly clean or wholly dirty —
    # so a stable sort interleaves the two streams into cold-build order
    # while preserving each group's chunk order
    perm = np.argsort(keys, kind="stable")
    new_reg_steps = old_keep.size + mid_reg
    new_evil_steps = mid_evil if evil_dirty else old.n_evil_chunks
    if new_reg_steps + new_evil_steps == 0:
        return _rebuild_fallback(new_coo, "empty-schedule", **kwargs)

    win_reg = np.concatenate([kept_win, mid_win])[perm]
    cb_reg = np.concatenate([kept_cb, mid_cb])[perm]
    src_reg = np.concatenate([old_keep, np.full(mid_reg, -1, np.int64)])[perm]

    def merge_slots(old_a, mid_a):
        stacked = np.concatenate(
            [
                old_a[: old_reg_steps * k].reshape(old_reg_steps, k)[old_keep],
                mid_a[: mid_reg * k].reshape(mid_reg, k),
            ]
        )
        return stacked[perm].reshape(-1)

    val = merge_slots(old.val, mid.val)
    local_row = merge_slots(old.local_row, mid.local_row)
    local_col = merge_slots(old.local_col, mid.local_col)

    # ---- evil section ------------------------------------------------------
    if evil_dirty:
        win_ev = mid.win_id[mid_reg:].astype(np.int64)
        cb_ev = mid.col_block[mid_reg:].astype(np.int64)
        val_ev = mid.val[mid_reg * k :]
        lrow_ev = mid.local_row[mid_reg * k :]
        lcol_ev = mid.local_col[mid_reg * k :]
        src_ev = np.full(mid_evil, -1, np.int64)
    else:
        win_ev = old.win_id[old_reg_steps:].astype(np.int64) + win_shift
        cb_ev = old.col_block[old_reg_steps:].astype(np.int64)
        val_ev = old.val[old_reg_steps * k :]
        lrow_ev = old.local_row[old_reg_steps * k :]
        lcol_ev = old.local_col[old_reg_steps * k :]
        src_ev = np.arange(old_reg_steps, old.n_steps, dtype=np.int64)

    n_reg_w_new = int(ws_n.shape[0])
    if evil_dirty:
        evil_tail = mid.row_map[n_reg_w_new * r :]
    else:
        evil_tail = old.row_map[ws_o.shape[0] * r :]
    row_map = np.concatenate([mid.row_map[: n_reg_w_new * r], evil_tail])

    sched = Schedule(
        win_id=np.concatenate([win_reg, win_ev]).astype(np.int32),
        col_block=np.concatenate([cb_reg, cb_ev]).astype(np.int32),
        val=np.concatenate([val, val_ev]),
        local_row=np.concatenate([local_row, lrow_ev]),
        local_col=np.concatenate([local_col, lcol_ev]),
        row_map=row_map.astype(np.int32, copy=False),
        shape=(m, n),
        nnz_per_step=k,
        rows_per_window=r,
        cols_per_block=cb,
        nnz=int(row_n.size),
        n_evil_chunks=int(new_evil_steps),
    )
    if sched.val.shape[0] != sched.n_steps * k:
        return _rebuild_fallback(new_coo, "splice-length-mismatch", **kwargs)
    stats = RepairStats(
        fell_back=False,
        reason="",
        win_shift=win_shift,
        reused_reg_steps=int(old_keep.size),
        emitted_reg_steps=int(mid_reg),
        old_reg_steps=old_reg_steps,
        new_reg_steps=int(new_reg_steps),
        old_evil_steps=old.n_evil_chunks,
        new_evil_steps=int(new_evil_steps),
        evil_dirty=evil_dirty,
        windows_reused=int(old_clean.size),
        windows_total=sched.n_windows,
        step_src=np.concatenate([src_reg, src_ev]),
    )
    return sched, stats


def build_naive_schedule(
    a: fmt.COO,
    nnz_per_step: int = 256,
    rows_per_window: int = 64,
    cols_per_block: int | None = None,
) -> Schedule:
    """Paper baseline (§III.B): uniform static row partition, no rebalancing.
    Every row block issues the step count of the *heaviest* block — the
    static-grid cost of workload imbalance (idle PEs ≡ padded slots)."""
    m, n = a.shape
    row, col, val = _clean_coo(a)
    r = rows_per_window
    cb = _resolve_cols_per_block(n, cols_per_block)
    window_of_row = (np.arange(m, dtype=np.int32) // np.int32(r)).astype(
        np.int32, copy=False
    )
    window_start = np.arange(0, max(m, 1), r, dtype=np.int32)
    evil_mask = np.zeros(m, bool)  # baseline has no evil-row handling
    return _emit(
        row,
        col,
        val,
        (m, n),
        nnz_per_step,
        r,
        cb,
        window_of_row,
        window_start,
        evil_mask,
        uniform=True,
    )


def scatter_epilogue(sched: Schedule, out_perm: torch.Tensor) -> torch.Tensor:
    """Map the permuted-window output back to matrix rows. Evil chunks
    scatter-add into their owner rows — the adder tree."""
    m = sched.shape[0]
    rm = torch.from_numpy(sched.row_map).to(out_perm.device)
    valid = rm >= 0
    contrib = torch.where(valid[:, None], out_perm, 0)
    out = out_perm.new_zeros((m, out_perm.shape[1]))
    return out.index_add_(0, torch.where(valid, rm, 0).long(), contrib)


def execute_schedule_torch(sched: Schedule, b: torch.Tensor) -> torch.Tensor:
    """Plain tensor executor of a Schedule — the port of the JAX package's
    ``execute_schedule_jnp``, the schedule-exact oracle of the SpMM kernel
    (tested itself against ``spmm.spmm_coo``). Runs on ``b``'s device."""
    _, n = sched.shape
    k = sched.nnz_per_step
    r = sched.rows_per_window
    kdim = b.shape[1]
    n_steps = sched.n_steps
    dev = b.device

    def t(x):
        return torch.from_numpy(x).to(dev)

    val = t(sched.val).to(b.dtype)
    lrow = t(sched.local_row).reshape(n_steps, k).long()
    lcol = t(sched.local_col).reshape(n_steps, k).long()
    win = t(sched.win_id).long()
    cblk = t(sched.col_block).long()

    gcol = torch.clamp(cblk[:, None] * sched.cols_per_block + lcol, max=n - 1)
    slot = (win[:, None] * r + lrow).reshape(-1)
    gathered = b[gcol.reshape(-1)] * val[:, None]
    out_perm = b.new_zeros((sched.n_windows * r, kdim))
    out_perm.index_add_(0, slot, gathered)
    return scatter_epilogue(sched, out_perm)
