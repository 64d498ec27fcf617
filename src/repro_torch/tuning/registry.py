"""In-process caches: graph fingerprint → schedule / executor.

The port of ``repro.tuning.registry``. ``graph_fingerprint`` hashes the same
bytes as the JAX package's, so both packages key one graph alike. The
fingerprint caches are unbounded (a serving system holds a handful of
long-lived graphs); the identity-keyed per-schedule cache is a bounded LRU.
Executors key on their placement as well — ``(mesh fingerprint, device
fingerprint)`` — so single-device copies of one graph on several devices
and sharded executors over several meshes coexist.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from repro_torch.core import csc as fmt
from repro_torch.core import executor as _exe
from repro_torch.core import reorder as _reorder
from repro_torch.core import schedule as _schedule
from repro_torch.core.executor import (
    ScheduleExecutor,
    ShardedScheduleExecutor,
    _ExecutorBase,
    select_routing,
)
from repro_torch.core.schedule import Schedule
from repro_torch.device import resolve_device, resolve_mesh


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


def delta_fingerprint(parent_fp: str, delta, revision: int) -> str:
    """Chained identity of a streamed graph mutation: the parent's
    fingerprint hashed with the repair generation and the edge delta's
    bytes — the same string the JAX package computes. O(|delta|) instead of
    the O(nnz) content hash: the streaming path's cheap lineage identity.
    Two graphs reached by the same delta sequence share it; unlike
    ``graph_fingerprint`` it is *not* content-canonical, so store entries
    keep using the content hash."""
    h = hashlib.blake2b(digest_size=16)
    h.update(parent_fp.encode())
    h.update(repr(int(revision)).encode())
    h.update(fmt.to_numpy(delta.row).tobytes())
    h.update(fmt.to_numpy(delta.col).tobytes())
    h.update(fmt.to_numpy(delta.val).tobytes())
    return h.hexdigest()


def mesh_fingerprint(mesh=None, n_devices: Optional[int] = None):
    """Hashable identity of the requested device mesh — the first half of
    the executor cache's placement key.

    ``None`` (no mesh, no device count) means the plain single-device
    ``ScheduleExecutor``; ``n_devices=1`` is a *distinct* entry (a 1-device
    sharded executor), so single- and multi-device executors coexist in the
    cache. Positions key by ``(type, index)``: the same shape on other
    devices is another placement, and a mesh that names one device twice
    keys apart from one that names it once. Validation is
    ``device.resolve_mesh``'s (a count beyond the CUDA devices, or one that
    contradicts ``mesh``, raises)."""
    if mesh is None and n_devices is None:
        return None
    positions = resolve_mesh(n_devices, mesh)
    return (("dev",), (len(positions),), tuple((d.type, d.index) for d in positions))


def device_fingerprint(device) -> Optional[tuple]:
    """Hashable identity of a single-device placement: ``(type, index)`` of
    the resolved device (``None``, the card, resolves first); keys
    **same-graph replicas on different devices** apart in the cache."""
    dev = resolve_device(device)
    return (dev.type, dev.index)


_SCHEDULE_CACHE: dict = {}
_EXECUTOR_CACHE: dict = {}
_REORDER_CACHE: dict = {}
_EXEC_BY_SCHEDULE: "OrderedDict[tuple, _ExecutorBase]" = OrderedDict()
_EXEC_BY_SCHEDULE_CAP = 32


def clear_caches() -> None:
    """Drop every cached schedule/executor/device upload/tuning result
    (tests; also the closest thing to simulating a process restart
    in-process)."""
    from repro_torch.tuning import runner

    _SCHEDULE_CACHE.clear()
    _EXECUTOR_CACHE.clear()
    _REORDER_CACHE.clear()
    _EXEC_BY_SCHEDULE.clear()
    _exe._DEVICE_STEPS.clear()
    runner._AUTOTUNE_CACHE.clear()


def _sched_key(fp, nnz_per_step, rows_per_window, cols_per_block, window_nnz,
               balanced, reorder="none"):
    return (fp, nnz_per_step, rows_per_window, str(cols_per_block), window_nnz,
            balanced, reorder)


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


def adopt_reorder(fingerprint: str, strategy: str, perm: np.ndarray) -> None:
    """Seed the reorder cache with a store entry's persisted permutation,
    so the adopted schedule and the executor's un-permute stay consistent
    even when a fresh recompute would order ties differently."""
    if strategy == _reorder.REORDER_NONE or perm is None:
        return
    inv = _reorder.invert_permutation(perm)
    _REORDER_CACHE.setdefault(
        (fingerprint, strategy), (np.asarray(perm, np.int32), inv)
    )


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


def adopt_schedule(fingerprint: str, cfg, sched: Schedule) -> None:
    """Seed the schedule cache with a deserialized store entry, so the
    subsequent ``get_executor(a, **cfg.as_executor_kwargs())`` is a pure
    cache hit — **zero** ``build_balanced_schedule`` calls on the
    warm-start path."""
    key = _sched_key(fingerprint, cfg.nnz_per_step, cfg.rows_per_window,
                     cfg.cols_per_block, cfg.window_nnz, True,
                     getattr(cfg, "reorder", "none"))
    _SCHEDULE_CACHE.setdefault(key, sched)


def get_spmm_schedules(
    a: fmt.COO,
    *,
    nnz_per_step: int = 256,
    rows_per_window: int = 64,
    cols_per_block=None,
) -> Tuple[Schedule, Schedule]:
    """(schedule for A, schedule for Aᵀ), both fingerprint-cached — what a
    differentiable SpMM needs (d(A@B)/dB = Aᵀ @ dC). Call sites stop
    rebuilding both schedules per invocation."""
    kw = dict(nnz_per_step=nnz_per_step, rows_per_window=rows_per_window,
              cols_per_block=cols_per_block)
    return get_schedule(a, **kw), get_schedule(fmt.transpose_coo(a), **kw)


def _placement_key(mesh, n_devices, device):
    """(mesh fingerprint, device fingerprint) with the combination rules:
    ``device`` pins a single-device executor, so it contradicts a mesh."""
    if device is not None and (mesh is not None or n_devices is not None):
        raise ValueError(
            "device= pins a single-device executor to one placement; it "
            "cannot be combined with n_devices/mesh"
        )
    mkey = mesh_fingerprint(mesh, n_devices)
    return mkey, (None if mkey is not None else device_fingerprint(device))


def _build(sched: Schedule, mkey, *, n_devices, mesh, device, **kw) -> _ExecutorBase:
    if mkey is None:
        return ScheduleExecutor(sched, device=device, **kw)
    return ShardedScheduleExecutor(sched, n_devices=n_devices, mesh=mesh, **kw)


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
) -> _ExecutorBase:
    """Fingerprint-cached executor: the first call converges (builds the
    schedule, uploads it); every later call with the same graph, config and
    placement is a cache hit — no rebuild, no host→device transfer.

    Pass ``n_devices`` (the first CUDA devices) or ``mesh`` (a list of
    devices, ``device.resolve_mesh``) for a ``ShardedScheduleExecutor``
    whose step shards live one per position, or ``device`` (default: the
    card) for a ``ScheduleExecutor`` on one device. The cache keys on
    ``(graph fingerprint, mesh, device)``, so single-, multi-device and
    per-replica executors of the same graph coexist."""
    mkey, dkey = _placement_key(mesh, n_devices, device)
    fp = graph_fingerprint(a)
    key = (
        _sched_key(fp, nnz_per_step, rows_per_window, cols_per_block,
                   window_nnz, balanced, reorder),
        ktile,
        routing,
        bf16_accumulate,
        mkey,
        dkey,
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
        ex = _build(sched, mkey, n_devices=n_devices, mesh=mesh, device=device,
                    ktile=ktile, routing=routing, bf16_accumulate=bf16_accumulate,
                    row_unperm=inv)
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
) -> _ExecutorBase:
    """Executor for a caller-built schedule, memoized per (schedule
    instance, ktile, routing, accumulation, mesh, device) — identity-keyed,
    so rebuilding a schedule re-uploads while reusing one doesn't, and
    asking for another routing, mesh or device never returns a mismatched
    cached executor."""
    mkey, dkey = _placement_key(mesh, n_devices, device)
    routing = routing or select_routing(
        sched.nnz_per_step, sched.cols_per_block, sched.rows_per_window, ktile
    )
    key = (id(sched), ktile, routing, bf16_accumulate, mkey, dkey)
    ex = _EXEC_BY_SCHEDULE.get(key)
    if ex is not None and ex.sched is sched:
        _EXEC_BY_SCHEDULE.move_to_end(key)
        return ex
    ex = _build(sched, mkey, n_devices=n_devices, mesh=mesh, device=device,
                ktile=ktile, routing=routing, bf16_accumulate=bf16_accumulate)
    _EXEC_BY_SCHEDULE[key] = ex
    if len(_EXEC_BY_SCHEDULE) > _EXEC_BY_SCHEDULE_CAP:
        _EXEC_BY_SCHEDULE.popitem(last=False)
    return ex
