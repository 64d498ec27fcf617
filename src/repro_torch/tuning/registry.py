"""In-process caches: graph fingerprint → schedule / executor.

The single-device part of ``repro.tuning.registry``. ``graph_fingerprint``
hashes the same bytes as the JAX package's, so both packages key one graph
alike. The fingerprint caches are unbounded (a serving system holds a
handful of long-lived graphs); the identity-keyed per-schedule cache is a
bounded LRU. Executors key on their device as well, so copies of one graph
on several devices coexist.

Multi-device executors (``n_devices``/``mesh``) belong to the sharded slice
of the port and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Optional

from repro_torch.core import csc as fmt
from repro_torch.core import executor as _exe
from repro_torch.core import reorder as _reorder
from repro_torch.core import schedule as _schedule
from repro_torch.core.executor import ScheduleExecutor, select_routing
from repro_torch.core.schedule import Schedule
from repro_torch.device import resolve_device


def graph_fingerprint(a: fmt.COO) -> str:
    """Content hash of a sparse operand — the schedule-cache key.

    Hashes shape, true nnz, and the index/value bytes of real (non-PAD)
    entries, so two COOs describing the same matrix — padded or not — map
    to the same converged configuration.
    """
    row = fmt.to_numpy(a.row)
    col = fmt.to_numpy(a.col)
    val = fmt.to_numpy(a.val)
    if (row == fmt.PAD_IDX).any():
        keep = row != fmt.PAD_IDX
        row, col, val = row[keep], col[keep], val[keep]
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((a.shape, int(row.shape[0]))).encode())
    h.update(row.tobytes())
    h.update(col.tobytes())
    h.update(val.tobytes())
    return h.hexdigest()


_SCHEDULE_CACHE: dict = {}
_EXECUTOR_CACHE: dict = {}
_REORDER_CACHE: dict = {}
_EXEC_BY_SCHEDULE: "OrderedDict[tuple, ScheduleExecutor]" = OrderedDict()
_EXEC_BY_SCHEDULE_CAP = 32


def clear_caches() -> None:
    """Drop every cached schedule/executor/device upload."""
    _SCHEDULE_CACHE.clear()
    _EXECUTOR_CACHE.clear()
    _REORDER_CACHE.clear()
    _EXEC_BY_SCHEDULE.clear()
    _exe._DEVICE_STEPS.clear()


def _sched_key(fp, nnz_per_step, rows_per_window, cols_per_block, window_nnz,
               balanced, reorder="none"):
    return (fp, nnz_per_step, rows_per_window, str(cols_per_block), window_nnz,
            balanced, reorder)


def _single_device(n_devices, mesh, device):
    if n_devices is not None or mesh is not None:
        raise NotImplementedError(
            "multi-device executors (n_devices/mesh) are not ported yet"
        )
    return resolve_device(device)


def get_reorder(a: fmt.COO, strategy: str, fingerprint: Optional[str] = None):
    """Fingerprint-cached ``(perm, inv)`` for one reorder strategy;
    ``(None, None)`` for ``"none"``."""
    if strategy == _reorder.REORDER_NONE:
        return None, None
    fp = fingerprint or graph_fingerprint(a)
    key = (fp, strategy)
    pair = _REORDER_CACHE.get(key)
    if pair is None:
        pair = _reorder.permutation(a, strategy)
        _REORDER_CACHE[key] = pair
    return pair


def release_graph(fingerprint: str) -> None:
    """Drop every cached schedule/executor/permutation of one graph, and
    the schedules' device uploads."""
    for key in [k for k in _SCHEDULE_CACHE if k[0] == fingerprint]:
        _exe.release_device_steps(_SCHEDULE_CACHE.pop(key))
    for key in [k for k in _EXECUTOR_CACHE if k[0][0] == fingerprint]:
        del _EXECUTOR_CACHE[key]
    for key in [k for k in _REORDER_CACHE if k[0] == fingerprint]:
        del _REORDER_CACHE[key]


def get_schedule(
    a: fmt.COO,
    *,
    nnz_per_step: int = 256,
    rows_per_window: int = 64,
    cols_per_block=None,
    window_nnz: Optional[int] = None,
    balanced: bool = True,
    reorder: str = "none",
    fingerprint: Optional[str] = None,
) -> Schedule:
    """Fingerprint-cached schedule build — the 'reuse the converged
    configuration' entry point. ``reorder`` builds on the row-permuted graph
    (``core.reorder``); the matching executor un-permutes outputs."""
    fp = fingerprint or graph_fingerprint(a)
    key = _sched_key(fp, nnz_per_step, rows_per_window, cols_per_block,
                     window_nnz, balanced, reorder)
    sched = _SCHEDULE_CACHE.get(key)
    if sched is None:
        if reorder != _reorder.REORDER_NONE:
            perm, _ = get_reorder(a, reorder, fingerprint=fp)
            a = fmt.permute_coo(a, perm)
        if balanced:
            sched = _schedule.build_balanced_schedule(
                a, nnz_per_step, rows_per_window, cols_per_block=cols_per_block,
                window_nnz=window_nnz,
            )
        else:
            sched = _schedule.build_naive_schedule(
                a, nnz_per_step, rows_per_window, cols_per_block=cols_per_block
            )
        _SCHEDULE_CACHE[key] = sched
    return sched


def get_executor(
    a: fmt.COO,
    *,
    nnz_per_step: int = 256,
    rows_per_window: int = 64,
    cols_per_block=None,
    window_nnz: Optional[int] = None,
    ktile: int = 128,
    routing: Optional[str] = None,
    balanced: bool = True,
    bf16_accumulate: bool = False,
    n_devices: Optional[int] = None,
    mesh=None,
    device=None,
    reorder: str = "none",
) -> ScheduleExecutor:
    """Fingerprint-cached executor on ``device`` (default: the card): the
    first call converges (builds the schedule, uploads it); every later call
    with the same graph, config and device is a cache hit — no rebuild, no
    host→device transfer."""
    dev = _single_device(n_devices, mesh, device)
    fp = graph_fingerprint(a)
    key = (
        _sched_key(fp, nnz_per_step, rows_per_window, cols_per_block,
                   window_nnz, balanced, reorder),
        ktile,
        routing,
        bf16_accumulate,
        str(dev),
    )
    ex = _EXECUTOR_CACHE.get(key)
    if ex is None:
        sched = get_schedule(
            a,
            nnz_per_step=nnz_per_step,
            rows_per_window=rows_per_window,
            cols_per_block=cols_per_block,
            window_nnz=window_nnz,
            balanced=balanced,
            reorder=reorder,
            fingerprint=fp,
        )
        _, inv = get_reorder(a, reorder, fingerprint=fp)
        ex = ScheduleExecutor(
            sched,
            ktile=ktile,
            routing=routing,
            bf16_accumulate=bf16_accumulate,
            device=dev,
            row_unperm=inv,
        )
        _EXECUTOR_CACHE[key] = ex
    return ex


def executor_for_schedule(
    sched: Schedule,
    *,
    ktile: int = 128,
    routing: Optional[str] = None,
    bf16_accumulate: bool = False,
    n_devices: Optional[int] = None,
    mesh=None,
    device=None,
) -> ScheduleExecutor:
    """Executor for a caller-built schedule, memoized per (schedule
    instance, ktile, routing, accumulation, device) — identity-keyed, so
    rebuilding a schedule re-uploads while reusing one doesn't."""
    dev = _single_device(n_devices, mesh, device)
    routing = routing or select_routing(
        sched.nnz_per_step, sched.cols_per_block, sched.rows_per_window, ktile
    )
    key = (id(sched), ktile, routing, bf16_accumulate, str(dev))
    ex = _EXEC_BY_SCHEDULE.get(key)
    if ex is not None and ex.sched is sched:
        _EXEC_BY_SCHEDULE.move_to_end(key)
        return ex
    ex = ScheduleExecutor(
        sched, ktile=ktile, routing=routing, bf16_accumulate=bf16_accumulate,
        device=dev,
    )
    _EXEC_BY_SCHEDULE[key] = ex
    if len(_EXEC_BY_SCHEDULE) > _EXEC_BY_SCHEDULE_CAP:
        _EXEC_BY_SCHEDULE.popitem(last=False)
    return ex
