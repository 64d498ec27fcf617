"""ScheduleExecutor — the converged AWB configuration as a device-resident
artifact; ``ShardedScheduleExecutor`` — the same plan across a device mesh.

The port of ``repro.core.executor``. ``ScheduleExecutor`` uploads a
``Schedule``'s arrays to its device once at construction; every
``spmm``/``forward``/``forward_batch`` call then moves only the dense
operand. ``ShardedScheduleExecutor`` splits the schedule's equal-work steps
into contiguous ranges, one per mesh position (``sharding.schedule_shard``),
uploads each range to its position's device, runs each position's shard
there and sums the positions' ``[m, kdim]`` partial outputs onto the first
position's device in position order — the reference's ``shard_map`` body
and ``psum``, in one process (DESIGN.md §4). A mesh is a list of devices
and may name one device more than once (``device.resolve_mesh``).

On a CUDA device both routings run the hand-written kernels of
``kernels/spmm_cuda.py``: the gather/one-hot split is a TPU artifact (VPU
gather against MXU contractions) that Hopper does not share. On the CPU the
two routing bodies are tensor ops that mirror the JAX package's
``_gather_impl`` (chunked gather, scale, ``index_add_`` into output rows with
``row_map`` precomposed) and ``_onehot_impl`` (each step's two one-hot
contractions, then the scatter epilogue).

Streaming updates (``repaired_executor``, ``value_patched_executor``) make a
new executor from an old one and a repaired or value-patched schedule,
reusing what the update left alone and never writing into a tensor the old
executor holds (copy-on-write: clone, then write the clone). On CUDA the
kernels' plan is spliced on the host (``spmm_cuda.splice_plan``) instead of
re-planned, and only the changed slot records go up when the record layout
is unchanged; a sharded executor splices and re-uploads only the positions
whose steps changed.

The executor serves inference: its methods record no autograd graph.
"""

from __future__ import annotations

from collections import OrderedDict
from functools import reduce
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.schedule import Schedule
from repro_torch.core.spmm import GATHER_ELEMS
from repro_torch.device import resolve_device, resolve_mesh
from repro_torch.kernels import spmm_cuda
from repro_torch.lazyexports import lazy_exports
from repro_torch.sharding.schedule_shard import shard_schedule, split_step_ranges

GATHER = "gather"
ONEHOT = "onehot"

# cost-model constants of the JAX package (a v5e-class TPU core: 128×128
# MXU MAC/cycle and a VMEM gather-bandwidth proxy). Kept so the routing a
# config names means the same in both packages; on CUDA both routings run
# the same kernel.
_MXU_MACS_PER_CYCLE = 16384
_GATHER_BYTES_PER_CYCLE = 512


def routing_cost_model(k: int, cb: int, r: int, ktile: int = 128) -> dict:
    """Estimated per-step cycles of each routing path (relative units, TPU).

    one-hot: two MXU contractions → K·(CB+R)·ktile MACs.
    gather: K dynamic row fetches of a ktile-wide f32 row + the same one-hot
    scatter contraction.
    """
    onehot = k * (cb + r) * ktile / _MXU_MACS_PER_CYCLE
    gather = (
        k * ktile * 4 / _GATHER_BYTES_PER_CYCLE + k * r * ktile / _MXU_MACS_PER_CYCLE
    )
    return {ONEHOT: onehot, GATHER: gather}


def select_routing(k: int, cb: int, r: int, ktile: int = 128) -> str:
    """The cheaper routing under ``routing_cost_model``: one-hot when the
    column block is capped small, gather when it spans a wide operand."""
    cost = routing_cost_model(k, cb, r, ktile)
    return ONEHOT if cost[ONEHOT] <= cost[GATHER] else GATHER


class InjectedFault(RuntimeError):
    """Raised by ``FaultInjector.check`` at an armed seam (the default
    exception type; ``arm(exc=...)`` substitutes another)."""


#: wildcard filter value for FaultInjector.arm — matches any context
ANY = object()


class FaultInjector:
    """Deterministic failure injection for the executor stack.

    Production code calls ``check(site, **ctx)`` at named seams; the call is
    free when nothing is armed, and raises when an armed fault matches. The
    seams:

    * ``"upload"`` — host→device array upload, context ``device=``.
    * ``"dispatch"`` — the serving engine's batch dispatch, context
      ``graph=``: fails the whole dispatch before any work is charged.
    * ``"replica_chunk"`` — one replica's sub-batch, context ``graph=``/
      ``device=`` (the engine's device index): fails exactly one clone's
      chunk, leaving its siblings healthy.

    ``arm(site, times=n)`` fires the next ``n`` matching checks (filters
    ``graph=``/``device=`` restrict the match; default matches any).
    ``clear()`` disarms everything; ``fired`` logs each raised fault as
    ``(site, graph, device)``. Test seam only — never arm in production.
    """

    def __init__(self):
        self._armed: list = []
        self.fired: list = []

    def arm(
        self, site: str, *, times: int = 1, exc=None, graph=ANY, device=ANY
    ) -> None:
        self._armed.append(
            {
                "site": site,
                "times": int(times),
                "exc": exc,
                "graph": graph,
                "device": device,
            }
        )

    def clear(self) -> None:
        self._armed.clear()
        self.fired.clear()

    def check(self, site: str, *, graph=None, device=None) -> None:
        if not self._armed:
            return
        for f in self._armed:
            if f["site"] != site:
                continue
            if f["graph"] is not ANY and f["graph"] != graph:
                continue
            if f["device"] is not ANY and f["device"] != device:
                continue
            f["times"] -= 1
            if f["times"] <= 0:
                self._armed.remove(f)
            self.fired.append((site, graph, device))
            raise (
                f["exc"]
                if f["exc"] is not None
                else InjectedFault(
                    f"injected {site} fault (graph={graph!r}, "
                    f"device={device!r})"
                )
            )


#: process-wide injector instance the seams consult (tests arm/clear it)
FAULTS = FaultInjector()

#: floor (slot-array bytes) below which a repair re-uploads in full instead
#: of patching the moved slots into a clone of the old device array: the
#: scoped patch saves transfer bandwidth on large graphs, but a small
#: graph's plain re-upload beats its extra operations; tests pin this to 0
#: to exercise the scoped path.
SCOPED_UPLOAD_MIN_BYTES = 16 * 1024 * 1024


# Device copies of schedule arrays in the kernels' layout, shared between
# ScheduleExecutor and the kernel wrapper so one schedule is uploaded once
# no matter who consumes it. Keyed on (schedule identity, device), bounded
# LRU; each entry is (schedule, DeviceSteps, host plan). An upload that a
# mesh position owns apart adds a tag to its key: a serving engine's
# clone, by its position (``ScheduleExecutor(position=)``), and a sharded
# executor's step range, by ``("shard", lo, hi)`` — so positions that name
# one device never share or collide.
_DEVICE_STEPS: "OrderedDict[tuple, tuple]" = OrderedDict()
_DEVICE_STEPS_CAP = 32


def _placed(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload host array ``x`` to ``device``."""
    FAULTS.check("upload", device=device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _upload_plan(plan: dict, shape, device: torch.device) -> spmm_cuda.DeviceSteps:
    """``DeviceSteps`` of a host plan: its ``DEVICE_FIELDS`` uploaded."""
    return spmm_cuda.DeviceSteps(
        **{k: _placed(plan[k], device) for k in spmm_cuda.DEVICE_FIELDS},
        shape=shape,
        n_parts=int(plan["part_ptr"][-1]),
    )


def _memo_key(sched: Schedule, device: torch.device, tag=None) -> tuple:
    key = (id(sched), str(device))
    return key if tag is None else key + (tag,)


def _remember(sched: Schedule, device: torch.device, steps, plan: dict,
              tag=None) -> None:
    """Memoize ``sched``'s upload on ``device`` (under ``tag``) with its
    host plan."""
    key = _memo_key(sched, device, tag)
    _DEVICE_STEPS[key] = (sched, steps, plan)
    _DEVICE_STEPS.move_to_end(key)
    if len(_DEVICE_STEPS) > _DEVICE_STEPS_CAP:
        _DEVICE_STEPS.popitem(last=False)


def _device_plan(sched: Schedule, device: torch.device, tag=None, steps=None):
    """``(DeviceSteps, host plan)`` of ``sched``'s ``steps`` (None: all) on a
    resolved ``device``, planned and uploaded once per (schedule instance,
    device, tag)."""
    key = _memo_key(sched, device, tag)
    hit = _DEVICE_STEPS.get(key)
    if hit is not None and hit[0] is sched:
        _DEVICE_STEPS.move_to_end(key)
        return hit[1], hit[2]
    plan = (spmm_cuda.kernel_plan(sched) if steps is None
            else spmm_cuda.kernel_plan(sched, steps))
    dsteps = _upload_plan(plan, sched.shape, device)
    _remember(sched, device, dsteps, plan, tag)
    return dsteps, plan


def device_step_arrays(sched: Schedule, device=None) -> spmm_cuda.DeviceSteps:
    """The schedule's ``spmm_cuda.DeviceSteps`` on ``device`` (default: the
    card) — the kernels' slot records and step and epilogue index arrays —
    uploaded once per (schedule instance, device) and memoized (bounded
    LRU)."""
    return _device_plan(sched, resolve_device(device))[0]


def patched_steps(old_steps: spmm_cuda.DeviceSteps, old_plan: dict,
                  nnz_per_step: int, slots, vals):
    """``(DeviceSteps, host plan)`` after a value patch of flat schedule
    ``slots`` to the non-zero ``vals`` (``spmm_cuda.value_patch_plan``):
    the changed records go into a clone of the old ones on their device;
    every other array is the old one. An empty patch shares everything."""
    if np.asarray(slots).size == 0:
        return old_steps, old_plan
    plan, rec = spmm_cuda.value_patch_plan(old_plan, nnz_per_step, slots, vals)
    return old_steps._replace(slots=_patched_records(old_steps.slots, plan, rec)), plan


def _patched_records(old: torch.Tensor, plan: dict, idx: np.ndarray) -> torch.Tensor:
    """A clone of the old records with rows ``idx`` taken from ``plan``'s:
    on the records' device and its current stream (the stream serving
    uses), so the old records, which in-flight batches may still read,
    stay as they were."""
    FAULTS.check("upload", device=old.device)
    records = old.clone()
    records.index_copy_(0, torch.from_numpy(idx).to(old.device),
                        torch.from_numpy(plan["slots"][idx]).to(old.device))
    return records


def _ranges(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """``concatenate([arange(s, s + n) for s, n in zip(starts, lengths)])``."""
    first = np.cumsum(lengths) - lengths
    return np.repeat(starts - first, lengths) + np.arange(int(lengths.sum()))


def spliced_steps(old_steps: spmm_cuda.DeviceSteps, old_plan: dict,
                  new_sched: Schedule, repair, tag=None):
    """``(DeviceSteps, host plan, scoped)`` of a repaired schedule from the
    old upload and plan (``spmm_cuda.splice_plan`` over the repair's
    ``step_src``); a repair that fell back to a full rebuild is planned
    and uploaded cold (``scoped`` False), under the memo ``tag``."""
    dev = old_steps.slots.device
    if repair.fell_back or repair.step_src is None:
        return (*_device_plan(new_sched, dev, tag), False)
    plan = spmm_cuda.splice_plan(old_plan, new_sched, repair.step_src)
    steps, scoped = _upload_spliced(plan, new_sched.shape, dev, old_steps,
                                    old_plan, repair.step_src)
    return steps, plan, scoped


def _upload_spliced(plan: dict, shape, dev: torch.device, old_steps=None,
                    old_plan=None, step_src=None):
    """``(DeviceSteps, scoped)`` of a spliced ``plan`` on ``dev``. When the
    records keep the layout of ``old_plan``'s (equal ``slot_ptr``), the
    moved steps' records (``step_src[s] != s``) are written into a clone of
    ``old_steps``' records on their device — if they are at most half of
    them and the records reach ``SCOPED_UPLOAD_MIN_BYTES`` — or the old
    records are shared when no step moved; ``scoped`` is then True.
    Otherwise (or without an old upload) the records go up whole. The small
    index arrays go up anew."""
    small = {k: _placed(plan[k], dev) for k in spmm_cuda.DEVICE_FIELDS[1:]}
    sp = plan["slot_ptr"]
    records, scoped = None, False
    if old_steps is not None and np.array_equal(sp, old_plan["slot_ptr"]):
        src = np.asarray(step_src, np.int64)
        moved = np.flatnonzero(src != np.arange(src.shape[0]))
        live = np.diff(sp)[moved].astype(np.int64)
        n_moved = int(live.sum())
        if n_moved == 0:
            records, scoped = old_steps.slots, True
        elif (2 * n_moved <= plan["slots"].shape[0]
              and plan["slots"].nbytes >= SCOPED_UPLOAD_MIN_BYTES):
            idx = _ranges(sp[moved].astype(np.int64), live)
            records, scoped = _patched_records(old_steps.slots, plan, idx), True
    if records is None:
        records = _placed(plan["slots"], dev)
    steps = spmm_cuda.DeviceSteps(slots=records, **small, shape=shape,
                                  n_parts=int(plan["part_ptr"][-1]))
    return steps, scoped


def _runs_kernels(device: torch.device) -> bool:
    """Whether an executor on ``device`` runs the kernels' plan: on CUDA;
    elsewhere the routing bodies. A seam: a test or a rehearsal may send a
    host executor down the kernels' path, where each kernel wrapper takes
    its plain version for a tensor on the CPU."""
    return device.type == "cuda"


class OneHotSteps(NamedTuple):
    """The one-hot routing's schedule arrays on one device, step-major."""

    val: torch.Tensor  # [n_steps, K] f32
    lrow: torch.Tensor  # [n_steps, K] int32
    lcol: torch.Tensor  # [n_steps, K] int32
    win: torch.Tensor  # [n_steps] int32
    cblk: torch.Tensor  # [n_steps] int32
    row_map: torch.Tensor  # [n_windows * R] int32, -1 on dead slots


def _onehot_steps(sched: Schedule, device: torch.device) -> OneHotSteps:
    n_steps, k = sched.n_steps, sched.nnz_per_step
    return OneHotSteps(*(_placed(x, device) for x in (
        sched.val.reshape(n_steps, k), sched.local_row.reshape(n_steps, k),
        sched.local_col.reshape(n_steps, k), sched.win_id, sched.col_block,
        sched.row_map)))


#: sentinel for ``release_device_steps``: drop the copies on every device
ALL_DEVICES = object()


def release_device_steps(sched: Schedule, device=ALL_DEVICES, position=None) -> None:
    """Drop memoized device copies of one schedule's step arrays — on every
    device, or only on ``device`` (``None`` meaning the card): all of that
    device's copies, or with ``position`` only that mesh position's (what
    dropping one replica of a graph on a mesh that names the device more
    than once needs)."""
    sid = id(sched)
    if device is ALL_DEVICES:
        keys = [k for k in _DEVICE_STEPS if k[0] == sid]
    else:
        dev = str(resolve_device(device))
        keys = [k for k in _DEVICE_STEPS if k[0] == sid and k[1] == dev
                and (position is None or k[2:] == (position,))]
    for key in keys:
        del _DEVICE_STEPS[key]


def _gather_slots(sched: Schedule):
    """Per-slot flat arrays of the fused-gather routing: global B-row
    ``gcol``, output row ``tgt`` (``row_map ∘ slot`` precomposed; padding
    slots carry ``val == 0``, so a clamped target row accumulates nothing),
    and the slot values. All step-major, length ``n_steps * nnz_per_step``."""
    m, n = sched.shape
    k = sched.nnz_per_step
    r = sched.rows_per_window
    cb = sched.cols_per_block
    win_slot = np.repeat(sched.win_id.astype(np.int64), k)
    cblk_slot = np.repeat(sched.col_block.astype(np.int64), k)
    gcol = np.minimum(cblk_slot * cb + sched.local_col, n - 1)
    slot = win_slot * r + sched.local_row
    tgt = np.maximum(sched.row_map[slot], 0).astype(np.int32)
    return gcol.astype(np.int32), tgt, sched.val


def _gather_slots_steps(sched: Schedule, steps: np.ndarray):
    """``_gather_slots`` restricted to the given step indices."""
    _, n = sched.shape
    k = sched.nnz_per_step
    r = sched.rows_per_window
    cb = sched.cols_per_block
    steps = np.asarray(steps, np.int64)
    sl = (steps[:, None] * k + np.arange(k, dtype=np.int64)).reshape(-1)
    win = np.repeat(sched.win_id[steps].astype(np.int64), k)
    cblk = np.repeat(sched.col_block[steps].astype(np.int64), k)
    gcol = np.minimum(cblk * cb + sched.local_col[sl], n - 1).astype(np.int32)
    tgt = np.maximum(sched.row_map[win * r + sched.local_row[sl]], 0).astype(np.int32)
    return gcol, tgt, sched.val[sl]


def _spliced_host_slots(old_host, new_sched: Schedule, repair):
    """Host gather-slot arrays of a repaired schedule, spliced from the old
    executor's retained host slots plus freshly derived slots for the
    re-emitted steps. Returns ``(gcol, tgt, val, moved)`` where ``moved``
    flags steps whose position or content changed — the scoped re-upload
    set. Reused steps carry their slot payloads verbatim: the repair keeps
    a window-aligned step's ``gcol`` (same local cols and blocks), ``tgt``
    (the new ``row_map`` holds the same rows at the remapped window slots)
    and ``val``."""
    og, ot, ov = old_host
    k = new_sched.nnz_per_step
    src = np.asarray(repair.step_src, np.int64)
    s_new = src.shape[0]
    if s_new != new_sched.n_steps:
        raise ValueError("step_src does not match the repaired schedule")
    moved = src != np.arange(s_new, dtype=np.int64)
    reused = src >= 0
    fresh = np.nonzero(~reused)[0]
    fg, ft, fv = _gather_slots_steps(new_sched, fresh) if fresh.size else (None,) * 3

    def take(oa, fa, dtype):
        out = np.empty((s_new, k), dtype)
        out[reused] = oa.reshape(-1, k)[src[reused]]
        if fa is not None:
            out[~reused] = fa.reshape(-1, k)
        return out.reshape(-1)

    return take(og, fg, np.int32), take(ot, ft, np.int32), take(ov, fv, ov.dtype), moved


class RequestBatch(tuple):
    """A batch of requests as the ``[n, f]`` tensors they came as, in order:
    what ``forward_batch`` reads where a ``[B, n, f]`` operand would
    otherwise be stacked from them. ``shape`` is that operand's; a slice is
    a batch too (a replica's chunk)."""

    @property
    def shape(self) -> torch.Size:
        return torch.Size((len(self), *self[0].shape))

    def __getitem__(self, i):
        got = tuple.__getitem__(self, i)
        return RequestBatch(got) if isinstance(i, slice) else got


def request_batch(xs):
    """``xs`` in the form ``forward_batch`` reads: a ``[B, n, f]`` tensor
    as it is, any other sequence as a ``RequestBatch`` of its requests
    (``torch.as_tensor``: no copy). Raises ``ValueError``, before anything
    is launched, for a tensor that is not 3-D, an empty batch, or requests
    that are not all of one ``[n, f]`` shape."""
    if isinstance(xs, torch.Tensor):
        if xs.dim() != 3:
            raise ValueError(f"requests must be [B, n, f]; got {tuple(xs.shape)}")
        return xs
    if not isinstance(xs, RequestBatch):
        xs = RequestBatch(torch.as_tensor(x) for x in xs)
    if not xs:
        raise ValueError("a batch needs at least one request")
    shapes = {tuple(x.shape) for x in xs}
    if len(shapes) != 1 or len(xs[0].shape) != 2:
        raise ValueError(f"requests must share one [n, f] shape; got {sorted(shapes)}")
    return xs


class _ExecutorBase:
    """Shared surface of the single- and multi-device executors: operand
    validation, the commit to the executor's device, and the whole-GCN
    forward loops (every layer's A × (X × W) through ``self._spmm_impl``).
    The methods record no autograd graph."""

    sched: Schedule
    routing: str
    bf16_accumulate: bool = False
    #: where operands are committed and outputs land (a sharded executor's
    #: first mesh position)
    device: torch.device

    @property
    def _acc_dtype(self):
        return torch.bfloat16 if self.bf16_accumulate else torch.float32

    @property
    def utilization(self) -> float:
        return self.sched.utilization

    def commit(self, x: torch.Tensor) -> torch.Tensor:
        """Move a dense operand to this executor's device."""
        return x.to(self.device)

    def _check_rows(self, rows: int, what: str) -> None:
        if rows != self.sched.shape[1]:
            raise ValueError(
                f"{what} has {rows} rows; schedule expects "
                f"{self.sched.shape[1]} (A is {self.sched.shape})"
            )

    @torch.no_grad()
    def spmm(self, b: torch.Tensor) -> torch.Tensor:
        """C = A @ b through the device-resident converged schedule."""
        self._check_rows(b.shape[0], "operand")
        return self._spmm_impl(self.commit(b))

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return self.spmm(b)

    @torch.no_grad()
    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Whole-GCN forward logits: every layer runs A × (X × W) here."""
        self._check_rows(x.shape[0], "features")
        params = {name: self.commit(w) for name, w in params.items()}
        return self._forward_impl(params, self.commit(x))

    @torch.no_grad()
    def forward_batch(self, params: dict, xs) -> torch.Tensor:
        """Logits of a batch of requests → ``[B, m, c]``: the port of the
        serving engine's ``vmap`` of ``_forward_impl``. ``xs`` is a
        ``[B, n, f]`` tensor or a sequence of ``B`` requests of one
        ``[n, f]`` shape (``request_batch``); a request of the sequence is
        committed to the executor's device on its own (no copy where it is
        there already) and its first X·W reads it where it lies, so no
        ``[B, n, f]`` operand is ever put together. Each request's X·W is
        its own product, of the shape ``forward`` takes, so a request's
        logits do not depend on the batch it came in (a replica that serves
        part of a batch gives the bits the whole batch would); each layer's
        SpMM then runs once on the requests' column-stacked ``[n, B·k]``
        operand. While a profiler records, each layer's X·W products, its
        SpMM and the layout copies before and after the SpMM are the ranges
        ``executor.xw``, ``executor.spmm`` and ``executor.layout``."""
        xs = request_batch(xs)
        self._check_rows(xs.shape[1], "features")
        params = {name: self.commit(w) for name, w in params.items()}
        h = self._commit_requests(xs)
        m, n = self.sched.shape
        bsz = len(h)
        n_layers = len(params)
        for i in range(n_layers):
            w = params[f"w{i}"]
            k = w.shape[1]
            xw = torch.empty((bsz, h.shape[1], k), device=self.device,
                             dtype=torch.promote_types(h[0].dtype, w.dtype))
            with tracing.span("executor.xw"):
                for j in range(bsz):
                    torch.matmul(h[j], w, out=xw[j])
            with tracing.span("executor.layout"):
                b = xw.permute(1, 0, 2).reshape(n, bsz * k)
            with tracing.span("executor.spmm"):
                y = self._spmm_impl(b)
            with tracing.span("executor.layout"):
                h = y.reshape(m, bsz, k).permute(1, 0, 2).contiguous()
            if i < n_layers - 1:
                h = torch.relu_(h)
        return h

    def _commit_requests(self, xs):
        """A batch on this executor's device: a ``[B, n, f]`` tensor as
        ``commit`` moves it; a ``RequestBatch`` request by request, in the
        dtype ``torch.stack`` would give them all (each a no-op where the
        request is there already in that dtype)."""
        if isinstance(xs, torch.Tensor):
            return self.commit(xs)
        dtype = reduce(torch.promote_types, (x.dtype for x in xs))
        return RequestBatch(self.commit(x).to(dtype) for x in xs)

    def _forward_impl(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        h = x
        n_layers = len(params)
        for i in range(n_layers):
            h = self._spmm_impl(h @ params[f"w{i}"])  # A × (X × W)
            if i < n_layers - 1:
                h = torch.relu(h)
        return h


def _onehot_body(sched: Schedule, s: OneHotSteps, b: torch.Tensor, acc) -> torch.Tensor:
    """Dense-routing emulation of the steps in ``s``: each step's two
    one-hot contractions against its [CB, kdim] B-panel, then the scatter
    epilogue into matrix rows ``[m, kdim]`` in ``acc``."""
    m, n = sched.shape
    k = sched.nnz_per_step
    r = sched.rows_per_window
    cb = sched.cols_per_block
    kdim = b.shape[-1]
    dev = b.device
    ncb = -(-n // cb)
    bp = torch.zeros((ncb * cb, kdim), dtype=acc, device=dev)
    bp[:n] = b.to(acc)
    bp = bp.reshape(ncb, cb, kdim)
    ar_cb = torch.arange(cb, device=dev)
    ar_r = torch.arange(r, device=dev)
    out_perm = torch.zeros((sched.n_windows, r, kdim), dtype=acc, device=dev)
    n_steps = s.win.shape[0]
    chunk = max(1, GATHER_ELEMS // (k * cb + cb * kdim + k * (r + kdim)))
    for lo in range(0, n_steps, chunk):
        sl = slice(lo, lo + chunk)
        gather = (s.lcol[sl, :, None] == ar_cb).to(acc)  # [c, K, CB]
        contrib = (gather @ bp[s.cblk[sl].long()]) * s.val[sl, :, None].to(acc)
        scatter = (s.lrow[sl, :, None] == ar_r).to(acc)  # [c, K, R]
        out_perm.index_add_(0, s.win[sl], scatter.transpose(1, 2) @ contrib)
    # scatter epilogue (adder tree): permuted window slots → matrix rows
    rm = s.row_map
    valid = rm >= 0
    contrib = torch.where(valid[:, None], out_perm.reshape(-1, kdim), 0)
    out = torch.zeros((m, kdim), dtype=acc, device=dev)
    out.index_add_(0, torch.where(valid, rm, 0), contrib)
    return out


def _gather_body(m: int, gcol, tgt, val, b: torch.Tensor, acc) -> torch.Tensor:
    """Fused-gather routing over chunked slot streams ``[n_chunks, chunk]``:
    B-row gather per slot, one ``index_add_`` into output rows ``[m, kdim]``
    in ``acc`` (row_map precomposed)."""
    bf = b.to(acc)
    out = torch.zeros((m, b.shape[-1]), dtype=acc, device=b.device)
    for i in range(gcol.shape[0]):
        g = bf.index_select(0, gcol[i]) * val[i].to(acc)[:, None]
        out.index_add_(0, tgt[i], g)
    return out


class ScheduleExecutor(_ExecutorBase):
    """Device-resident executor of one converged AWB schedule.

    Construction uploads the schedule to ``device`` (default: the card)
    once; ``device_bytes`` reports the resident footprint. ``position``
    (default None: the upload is shared with every other consumer of the
    schedule on that device) tags an upload a serving engine's mesh
    position owns apart.

    ``row_unperm`` supports locality-reordered schedules (core.reorder):
    when ``sched`` was built on a row-permuted graph, pass the inverse
    permutation (``inv[old_row] = new_row``) and every output comes back in
    **original** row order. On CUDA the epilogue kernel applies it in the
    same pass.

    ``bf16_accumulate=True`` runs the multiplies and accumulations in
    bfloat16: in the CPU routing bodies, and on CUDA through the kernels'
    bf16-accumulate variant (``spmm_cuda``, ``acc_dtype=torch.bfloat16``).
    """

    def __init__(
        self,
        sched: Schedule,
        *,
        ktile: int = 128,
        routing: Optional[str] = None,
        bf16_accumulate: bool = False,
        slot_chunk: int = 1 << 18,
        device=None,
        row_unperm=None,
        position=None,
    ):
        self.sched = sched
        self.ktile = ktile
        self.bf16_accumulate = bf16_accumulate
        self.device = resolve_device(device)
        self.position = position
        self._slot_chunk_arg = slot_chunk
        #: set by the streaming constructors: True when the last
        #: (re)construction uploaded only the changed slots, not the stream
        self.scoped_upload = False
        k = sched.nnz_per_step
        r = sched.rows_per_window
        cb = sched.cols_per_block
        self.routing = routing or select_routing(k, cb, r, ktile)
        self.row_unperm = (
            None if row_unperm is None else np.asarray(row_unperm, np.int32)
        )
        self._unperm = (
            None if self.row_unperm is None else _placed(self.row_unperm, self.device)
        )

        # ---- one-time host-side precompute + host→device upload ----------
        if _runs_kernels(self.device):
            # the host plan is kept so a repair can splice it (DESIGN.md §11)
            self._steps, self._plan = _device_plan(sched, self.device, position)
            self.device_bytes = self._steps.nbytes
        elif self.routing == GATHER:
            # host copies are retained so a repair can splice new slot
            # streams without re-deriving every step (DESIGN.md §11)
            self._host = _gather_slots(sched)
            self._upload_chunks()
        else:
            self._onehot = _onehot_steps(sched, self.device)
            self.device_bytes = sum(t.nbytes for t in self._onehot)
        if self._unperm is not None:
            self.device_bytes += int(self._unperm.nbytes)

    def _chunk_grid(self, s_total: int) -> None:
        """Pad the flat slot stream to a whole number of chunks, so the
        gather bounds its [chunk, kdim] intermediate."""
        self._slot_chunk = int(min(self._slot_chunk_arg, max(1, s_total)))
        self._n_chunks = -(-s_total // self._slot_chunk)

    def _upload_chunks(self) -> None:
        """Upload the host slot stream ``_host`` whole, chunked (CPU gather
        routing), and set ``device_bytes`` for it."""
        gcol, tgt, val = self._host
        s_total = gcol.shape[0]
        self._chunk_grid(s_total)
        pad = self._n_chunks * self._slot_chunk - s_total

        def _chunked(x, fill):
            x = np.concatenate([x, np.full(pad, fill, x.dtype)])
            return _placed(x.reshape(self._n_chunks, self._slot_chunk), self.device)

        self._gcol = _chunked(gcol, 0)
        self._tgt = _chunked(tgt, 0)
        self._val = _chunked(val, 0.0)
        self._chunk_bytes()

    def _chunk_bytes(self) -> None:
        self.device_bytes = int(self._gcol.nbytes + self._tgt.nbytes + self._val.nbytes)
        if self._unperm is not None:
            self.device_bytes += int(self._unperm.nbytes)

    def _kwargs(self) -> dict:
        """The construction arguments a cold rebuild of this executor takes."""
        return dict(ktile=self.ktile, routing=self.routing,
                    bf16_accumulate=self.bf16_accumulate,
                    slot_chunk=self._slot_chunk_arg, device=self.device,
                    row_unperm=self.row_unperm, position=self.position)

    def _sibling(self, new_sched: Schedule) -> "ScheduleExecutor":
        """A new executor object for ``new_sched`` with this one's settings
        and row un-permutation, its device arrays still to be set."""
        new = type(self).__new__(type(self))
        new.sched = new_sched
        new.ktile = self.ktile
        new.bf16_accumulate = self.bf16_accumulate
        new.device = self.device
        new.position = self.position
        new.routing = self.routing
        new._slot_chunk_arg = self._slot_chunk_arg
        new.row_unperm = self.row_unperm
        new._unperm = self._unperm
        return new

    @classmethod
    def _from_repair(cls, old_ex: "ScheduleExecutor", new_sched: Schedule,
                     repair) -> "ScheduleExecutor":
        """Executor for a repaired schedule that reuses the old executor's
        device arrays wherever the repair left steps untouched.

        CUDA: the kernels' host plan is spliced (``spliced_steps``; planned
        cold after a repair that fell back) and registered as
        ``new_sched``'s upload. CPU gather routing: the host
        slot stream is spliced (reused steps copy their old slot rows,
        re-emitted steps derive fresh ones), and when the chunk grid is
        unchanged only the *moved* slots are written, into clones of the old
        arrays; its one-hot routing, or a repair that fell back to a full
        rebuild, builds cold.

        The result is a **new** executor; ``old_ex`` is never mutated. Its
        arrays equal a cold ``ScheduleExecutor(new_sched, ...)``'s with the
        same arguments."""
        if _runs_kernels(old_ex.device):
            self = old_ex._sibling(new_sched)
            self._steps, self._plan, self.scoped_upload = spliced_steps(
                old_ex._steps, old_ex._plan, new_sched, repair, self.position)
            _remember(new_sched, self.device, self._steps, self._plan, self.position)
            self.device_bytes = self._steps.nbytes
            if self._unperm is not None:
                self.device_bytes += int(self._unperm.nbytes)
            return self
        if repair.fell_back or repair.step_src is None or old_ex.routing != GATHER:
            return cls(new_sched, **old_ex._kwargs())
        self = old_ex._sibling(new_sched)
        k = new_sched.nnz_per_step
        gcol, tgt, val, moved = _spliced_host_slots(old_ex._host, new_sched, repair)
        self._host = (gcol, tgt, val)
        s_total = gcol.shape[0]
        self._chunk_grid(s_total)
        # a scoped patch is sound only on an identical padded grid — same
        # slot count (so the old padding still pads) and same chunking (so
        # the accumulation order, hence the bitwise output, matches a cold
        # build)
        same_grid = (
            s_total == old_ex._host[0].shape[0]
            and self._slot_chunk == old_ex._slot_chunk
            and self._n_chunks == old_ex._n_chunks
        )
        n_moved = int(np.count_nonzero(moved)) * k
        if same_grid and n_moved == 0:
            # content and layout identical: share the old arrays (nothing
            # ever writes into an executor's arrays after construction)
            self._gcol, self._tgt, self._val = old_ex._gcol, old_ex._tgt, old_ex._val
            self.scoped_upload = True
        elif (
            same_grid
            and 2 * n_moved <= s_total
            and s_total * 12 >= SCOPED_UPLOAD_MIN_BYTES
        ):
            FAULTS.check("upload", device=self.device)
            steps = np.nonzero(moved)[0]
            idx = (steps[:, None] * k + np.arange(k, dtype=np.int64)).reshape(-1)
            didx = torch.from_numpy(idx).to(self.device)

            def _patch(old, host):
                new = old.clone()
                new.view(-1)[didx] = torch.from_numpy(host[idx]).to(self.device)
                return new

            self._gcol = _patch(old_ex._gcol, gcol)
            self._tgt = _patch(old_ex._tgt, tgt)
            self._val = _patch(old_ex._val, val)
            self.scoped_upload = True
        else:
            self._upload_chunks()
            self.scoped_upload = False
            return self
        self._chunk_bytes()
        return self

    @classmethod
    def _value_patched(cls, old_ex: "ScheduleExecutor", new_sched: Schedule,
                       slots: np.ndarray, vals: np.ndarray) -> "ScheduleExecutor":
        """Executor for a *value-only* patched schedule: structure (and so
        the slot layout) is byte-identical to ``old_ex``'s; only ``val``
        changed, at the flat ``slots``.

        O(|delta|) on the device: CUDA writes the new values' bits into a
        clone of the slot records (``patched_steps``) and shares every other
        array; the CPU gather routing shares ``_gcol``/``_tgt`` and writes
        the values into a clone of ``_val``. An empty patch shares
        everything. The one-hot routing on the CPU builds cold."""
        cuda = _runs_kernels(old_ex.device)
        if not cuda and old_ex.routing != GATHER:
            return cls(new_sched, **old_ex._kwargs())
        self = old_ex._sibling(new_sched)
        self.scoped_upload = True
        self.device_bytes = old_ex.device_bytes
        if cuda:
            self._steps, self._plan = patched_steps(
                old_ex._steps, old_ex._plan, new_sched.nnz_per_step, slots, vals)
            _remember(new_sched, self.device, self._steps, self._plan, self.position)
            return self
        self._slot_chunk, self._n_chunks = old_ex._slot_chunk, old_ex._n_chunks
        gcol, tgt, oval = old_ex._host
        val = oval.copy()
        val[slots] = np.asarray(vals, val.dtype)
        self._host = (gcol, tgt, val)
        self._gcol, self._tgt = old_ex._gcol, old_ex._tgt
        if slots.size == 0:
            self._val = old_ex._val
        else:
            FAULTS.check("upload", device=self.device)
            self._val = old_ex._val.clone()
            self._val.view(-1)[torch.from_numpy(slots).to(self.device)] = (
                torch.from_numpy(val[slots]).to(self.device))
        return self

    # ---- routing bodies ----------------------------------------------------

    def _spmm_impl(self, b: torch.Tensor) -> torch.Tensor:
        """The body chosen at construction: the kernels on CUDA, else the
        routing's CPU body. A method, not a bound method kept on the
        instance: that would be a reference cycle, and the executor's device
        arrays would then outlive its last reference until the cyclic
        garbage collector ran."""
        if _runs_kernels(self.device):
            return self._kernel_impl(b)
        if self.routing == GATHER:
            return self._gather_impl(b)
        return self._onehot_impl(b)

    def _kernel_impl(self, b: torch.Tensor) -> torch.Tensor:
        """The hand-written kernels: window accumulation, then the epilogue
        (with the row un-permutation folded in), in the accumulator dtype."""
        return spmm_cuda.spmm_balanced(
            self._steps, b.contiguous(), ktile=self.ktile, row_unperm=self._unperm,
            acc_dtype=self._acc_dtype,
        )

    def _gather_impl(self, b: torch.Tensor) -> torch.Tensor:
        """Fused-gather routing, chunked over the slot stream."""
        out = _gather_body(self.sched.shape[0], self._gcol, self._tgt, self._val, b,
                           self._acc_dtype)
        if self._unperm is not None:
            out = out.index_select(0, self._unperm)
        return out.to(b.dtype)

    def _onehot_impl(self, b: torch.Tensor) -> torch.Tensor:
        """Dense-routing emulation over every step, then the epilogue."""
        out = _onehot_body(self.sched, self._onehot, b, self._acc_dtype)
        if self._unperm is not None:
            out = out.index_select(0, self._unperm)
        return out.to(b.dtype)


class ShardedScheduleExecutor(_ExecutorBase):
    """Multi-device executor of one converged AWB schedule.

    The schedule is split by ``sharding.schedule_shard`` into contiguous
    per-position step ranges (steps are equal work, so equal counts are
    balanced positions — the paper's equal-work distribution across the PE
    array, lifted one level to the device mesh). Construction uploads each
    range to its position's device exactly once; ``spmm``/``forward`` then
    run every position's shard on its device and sum the positions'
    ``[m, kdim]`` partial outputs onto the first position's device, in
    position order, so repeated calls are bit-equal — the reference's
    ``psum``, the distributed adder tree that also reunites evil-row chunks
    and boundary-straddling windows living on different positions.

    ``mesh`` is a list of devices, one per position, and may name one
    device more than once; ``n_devices`` without a mesh takes the first
    CUDA devices (``device.resolve_mesh``). A position whose range is empty
    (``n_devices > n_steps``) runs nothing and adds nothing.

    On CUDA positions each range is planned apart for the hand-written
    kernels (``spmm_cuda.kernel_plan(sched, steps)``; its epilogue writes a
    whole ``[m, kdim]`` partial, zero where the range has no partial, with
    the row un-permutation folded in), and ``spmm`` launches the window and
    the epilogue kernel once per non-empty position. On CPU positions each
    runs the reference's bodies: the fused gather over stacked, chunked
    slot streams padded to a common length, or the one-hot step scan with a
    local epilogue. ``device_bytes`` sums what the positions uploaded; the
    row un-permutation goes up once per distinct device.
    """

    def __init__(
        self,
        sched: Schedule,
        *,
        n_devices: Optional[int] = None,
        mesh=None,
        ktile: int = 128,
        routing: Optional[str] = None,
        bf16_accumulate: bool = False,
        slot_chunk: int = 1 << 18,
        row_unperm=None,
    ):
        self.mesh = resolve_mesh(n_devices, mesh)
        self.n_devices = len(self.mesh)
        self.device = self.mesh[0]
        self.sched = sched
        self.ktile = ktile
        self.bf16_accumulate = bf16_accumulate
        self._slot_chunk_arg = slot_chunk
        self._kernels = _runs_kernels(self.device)
        self.row_unperm = (
            None if row_unperm is None else np.asarray(row_unperm, np.int32)
        )
        self._unperm = None if self.row_unperm is None else self._per_device(
            self.row_unperm)
        k = sched.nnz_per_step
        r = sched.rows_per_window
        cb = sched.cols_per_block
        self.routing = routing or select_routing(k, cb, r, ktile)
        #: set by the streaming constructors: True when the last
        #: (re)construction re-uploaded only the positions whose steps
        #: changed; ``dirty_devices`` counts those positions
        self.scoped_upload = False
        self.step_ranges = split_step_ranges(sched.n_steps, self.n_devices)

        # ---- one-time host-side split + per-position upload ---------------
        if self._kernels:
            self._steps, self._plans = [], []
            for d in range(self.n_devices):
                steps, plan = self._shard_plan(sched, d)
                self._steps.append(steps)
                self._plans.append(plan)
        elif self.routing == GATHER:
            # retained for incremental repair splicing (DESIGN.md §11)
            self._host = _gather_slots(sched)
            s_max = max(1, int((self.step_ranges[:, 1] - self.step_ranges[:, 0]).max()))
            length = s_max * k
            self._slot_chunk = int(min(slot_chunk, max(1, length)))
            self._n_chunks = -(-length // self._slot_chunk)
            gcol, tgt, val = self._host
            self._gcol = [self._shard_row(gcol, d, 0) for d in range(self.n_devices)]
            self._tgt = [self._shard_row(tgt, d, 0) for d in range(self.n_devices)]
            self._val = [self._shard_row(val, d, 0.0) for d in range(self.n_devices)]
        else:
            shards = shard_schedule(sched, self.n_devices)
            # the epilogue runs on each position before the sum: every
            # distinct device holds the row map once
            self._row_map = self._per_device(sched.row_map)
            self._onehot = [
                OneHotSteps(*(_placed(x[d], dev) for x in (
                    shards.val, shards.lrow, shards.lcol, shards.win, shards.cblk)),
                    self._row_map[str(dev)])
                for d, dev in enumerate(self.mesh)
            ]
        self._set_bytes()

    # ---- construction helpers ---------------------------------------------

    def _per_device(self, x: np.ndarray) -> dict:
        """``x`` uploaded once to each distinct device of the mesh."""
        out = {}
        for dev in self.mesh:
            if str(dev) not in out:
                out[str(dev)] = _placed(x, dev)
        return out

    def _shard_plan(self, sched: Schedule, d: int):
        """``(DeviceSteps, plan)`` of position ``d``'s range on its device
        (memoized under the range), or ``(None, None)`` for an empty one."""
        lo, hi = (int(x) for x in self.step_ranges[d])
        if lo == hi:
            return None, None
        return _device_plan(sched, self.mesh[d], ("shard", lo, hi), np.arange(lo, hi))

    def _shard_row(self, flat: np.ndarray, d: int, fill) -> torch.Tensor:
        """Position ``d``'s slice of a flat slot stream, padded to the common
        shard length and chunked, on its device (CPU gather routing)."""
        k = self.sched.nnz_per_step
        lo, hi = (int(x) for x in self.step_ranges[d])
        row = np.full(self._n_chunks * self._slot_chunk, fill, flat.dtype)
        row[: (hi - lo) * k] = flat[lo * k: hi * k]
        return _placed(row.reshape(self._n_chunks, self._slot_chunk), self.mesh[d])

    def _set_bytes(self) -> None:
        if self._kernels:
            total = sum(s.nbytes for s in self._steps if s is not None)
        elif self.routing == GATHER:
            total = sum(t.nbytes for t in self._gcol + self._tgt + self._val)
        else:
            total = sum(t.nbytes for oh in self._onehot for t in oh[:5])
            total += sum(t.nbytes for t in self._row_map.values())
        if self._unperm is not None:
            total += sum(t.nbytes for t in self._unperm.values())
        self.device_bytes = int(total)

    def _kwargs(self) -> dict:
        """The construction arguments a cold rebuild of this executor takes."""
        return dict(mesh=self.mesh, ktile=self.ktile, routing=self.routing,
                    bf16_accumulate=self.bf16_accumulate,
                    slot_chunk=self._slot_chunk_arg, row_unperm=self.row_unperm)

    def _sibling(self, new_sched: Schedule) -> "ShardedScheduleExecutor":
        """A new executor object for ``new_sched`` with this one's mesh,
        settings and row un-permutation, its device arrays still to be
        set."""
        new = type(self).__new__(type(self))
        for name in ("mesh", "n_devices", "device", "ktile", "bf16_accumulate",
                     "_slot_chunk_arg", "_kernels", "row_unperm", "_unperm",
                     "routing"):
            setattr(new, name, getattr(self, name))
        new.sched = new_sched
        new.step_ranges = split_step_ranges(new_sched.n_steps, self.n_devices)
        return new

    # ---- streaming updates -------------------------------------------------

    @classmethod
    def _from_repair(cls, old_ex: "ShardedScheduleExecutor", new_sched: Schedule,
                     repair) -> "ShardedScheduleExecutor":
        """Sharded executor for a repaired schedule, re-uploading only the
        positions whose steps moved or were re-emitted.

        CUDA: a position whose range is unchanged and whose steps all carry
        their old slots (``step_src[s] == s``) keeps its upload; any other
        position's plan is spliced (``spmm_cuda.splice_plan``) from the old
        plans of the positions its reused steps come from, and uploaded —
        into a clone of its old records when only its own steps moved and
        the layout held (``_upload_spliced``). A repair that fell back plans
        cold. CPU: as the reference — the step count must be unchanged (the
        split is then identical), the host slot stream is spliced and the
        dirty positions' rows re-uploaded; the one-hot routing, a fallback
        or a changed step count rebuild from scratch.

        The result is a **new** executor; ``old_ex`` keeps serving. Its
        arrays equal a cold build's with the same arguments."""
        if old_ex._kernels:
            if repair.fell_back or repair.step_src is None:
                return cls(new_sched, **old_ex._kwargs())
            return old_ex._spliced(new_sched, np.asarray(repair.step_src, np.int64))
        if (
            old_ex.routing != GATHER
            or repair.fell_back
            or repair.step_src is None
            or new_sched.n_steps != old_ex.sched.n_steps
        ):
            return cls(new_sched, **old_ex._kwargs())
        self = old_ex._sibling(new_sched)
        self._slot_chunk, self._n_chunks = old_ex._slot_chunk, old_ex._n_chunks
        gcol, tgt, val, moved = _spliced_host_slots(old_ex._host, new_sched, repair)
        self._host = (gcol, tgt, val)
        dirty = [bool(np.any(moved[lo:hi])) for lo, hi in self.step_ranges]

        def restack(old, flat, fill):
            return [self._shard_row(flat, d, fill) if dirty[d] else old[d]
                    for d in range(self.n_devices)]

        self._gcol = restack(old_ex._gcol, gcol, 0)
        self._tgt = restack(old_ex._tgt, tgt, 0)
        self._val = restack(old_ex._val, val, 0.0)
        self.scoped_upload = not all(dirty)
        self.dirty_devices = int(sum(dirty))
        self._set_bytes()
        return self

    def _spliced(self, new_sched: Schedule, src: np.ndarray) -> "ShardedScheduleExecutor":
        """The CUDA half of ``_from_repair``: per position, keep, or splice
        and upload (see there)."""
        new = self._sibling(new_sched)
        new._steps, new._plans, dirty = [], [], []
        old_hi = self.step_ranges[:, 1]
        for d, (lo, hi) in enumerate((int(a), int(b)) for a, b in new.step_ranges):
            dev = self.mesh[d]
            tag = ("shard", lo, hi)
            own = (lo, hi) == tuple(int(x) for x in self.step_ranges[d])
            s = src[lo:hi]
            if own and np.array_equal(s, np.arange(lo, hi)):
                steps, plan = self._steps[d], self._plans[d]
                dirty.append(False)
            elif lo == hi:
                steps, plan = None, None
                dirty.append(True)
            else:
                dirty.append(True)
                # the old positions this range's reused steps come from
                owner = np.searchsorted(old_hi, s[s >= 0], side="right")
                first = int(owner.min()) if owner.size else d
                last = int(owner.max()) if owner.size else d
                base = int(self.step_ranges[first, 0])
                old = spmm_cuda.concat_plans(self._plans[first:last + 1])
                local = np.where(s >= 0, s - base, -1)
                plan = spmm_cuda.splice_plan(old, new_sched, local, steps=np.arange(lo, hi))
                mine = own and first == last == d
                steps, _ = _upload_spliced(
                    plan, new_sched.shape, dev,
                    self._steps[d] if mine else None, self._plans[d] if mine else None,
                    local if mine else None)
            if steps is not None:
                _remember(new_sched, dev, steps, plan, tag)
            new._steps.append(steps)
            new._plans.append(plan)
        new.scoped_upload = not all(dirty)
        new.dirty_devices = int(sum(dirty))
        new._set_bytes()
        return new

    @classmethod
    def _value_patched(cls, old_ex: "ShardedScheduleExecutor", new_sched: Schedule,
                       slots: np.ndarray, vals: np.ndarray) -> "ShardedScheduleExecutor":
        """Sharded executor for a value-only patched schedule: slot layout
        and step split are identical to ``old_ex``, only ``val`` changed at
        ``slots``. Positions whose range holds no changed slot keep their
        uploads; CUDA writes the new values' bits into a clone of each dirty
        position's records (``patched_steps``), the CPU gather routing
        re-uploads each dirty position's ``val`` row. The one-hot routing
        on the CPU builds cold."""
        if not old_ex._kernels and old_ex.routing != GATHER:
            return cls(new_sched, **old_ex._kwargs())
        self = old_ex._sibling(new_sched)
        k = new_sched.nnz_per_step
        slots = np.asarray(slots, np.int64)
        vals = np.asarray(vals)
        step = slots // k
        dirty = [bool(np.any((step >= lo) & (step < hi))) for lo, hi in self.step_ranges]
        if self._kernels:
            self._steps, self._plans = list(old_ex._steps), list(old_ex._plans)
            for d, (lo, hi) in enumerate(self.step_ranges):
                if not dirty[d]:
                    continue
                sel = (step >= lo) & (step < hi)
                self._steps[d], self._plans[d] = patched_steps(
                    old_ex._steps[d], old_ex._plans[d], k, slots[sel] - lo * k, vals[sel])
                _remember(new_sched, self.mesh[d], self._steps[d], self._plans[d],
                          ("shard", int(lo), int(hi)))
        else:
            self._slot_chunk, self._n_chunks = old_ex._slot_chunk, old_ex._n_chunks
            gcol, tgt, oval = old_ex._host
            val = oval.copy()
            val[slots] = np.asarray(vals, val.dtype)
            self._host = (gcol, tgt, val)
            self._gcol, self._tgt = old_ex._gcol, old_ex._tgt
            self._val = [self._shard_row(val, d, 0.0) if dirty[d] else old_ex._val[d]
                         for d in range(self.n_devices)]
        self.scoped_upload = True
        self.dirty_devices = int(sum(dirty))
        self.device_bytes = old_ex.device_bytes
        return self

    # ---- routing bodies ----------------------------------------------------

    def _spmm_impl(self, b: torch.Tensor) -> torch.Tensor:
        """Every non-empty position's shard on its device, then the sum of
        the ``[m, kdim]`` partials onto ``self.device`` in position order.
        The operand goes to every device before any shard runs, and every
        shard is launched before any partial comes back: a partial's copy
        waits for its shard, so pulling one back before the next shard is
        launched would run the cards one after another."""
        acc = self._acc_dtype
        live = [d for d, (lo, hi) in enumerate(self.step_ranges) if lo != hi]
        operands = {}
        for d in live:
            dev = self.mesh[d]
            if str(dev) not in operands:
                operands[str(dev)] = b.to(dev).contiguous()
        partials = []
        for d in live:
            dev = self.mesh[d]
            bd = operands[str(dev)]
            if self._kernels:
                steps = self._steps[d]
                unperm = None if self._unperm is None else self._unperm[str(dev)]
                part = spmm_cuda.spmm_window(steps, bd, ktile=self.ktile, acc_dtype=acc)
                y = spmm_cuda.spmm_epilogue(steps, part, acc, unperm, acc_dtype=acc)
            elif self.routing == GATHER:
                y = _gather_body(self.sched.shape[0], self._gcol[d], self._tgt[d],
                                 self._val[d], bd, acc)
            else:
                y = _onehot_body(self.sched, self._onehot[d], bd, acc)
            partials.append(y)
        if not partials:
            return torch.zeros((self.sched.shape[0], b.shape[-1]), dtype=b.dtype,
                               device=self.device)
        out = partials[0].to(self.device)
        for y in partials[1:]:
            out = out.add_(y.to(self.device))
        if not self._kernels and self._unperm is not None:
            out = out.index_select(0, self._unperm[str(self.device)])
        return out.to(b.dtype)


def repaired_executor(old_ex, new_sched: Schedule, repair):
    """Executor for a repaired schedule (``schedule.repair_schedule``),
    reusing ``old_ex``'s device arrays wherever the repair left steps
    untouched — the scoped re-upload path of DESIGN.md §11.

    Dispatches on the old executor's class; always returns a **new**
    executor and never mutates ``old_ex``, so the serving tier can swap
    atomically while in-flight batches finish on the old one. Its device
    arrays equal a cold build's on ``new_sched`` with the same arguments."""
    if isinstance(old_ex, ShardedScheduleExecutor):
        return ShardedScheduleExecutor._from_repair(old_ex, new_sched, repair)
    if isinstance(old_ex, ScheduleExecutor):
        return ScheduleExecutor._from_repair(old_ex, new_sched, repair)
    raise TypeError(f"unsupported executor type: {type(old_ex).__name__}")


def value_patched_executor(old_ex, new_sched: Schedule, slots, vals):
    """Executor for a schedule produced by ``schedule.value_patch_schedule``
    — structure unchanged, only ``val[slots]`` differ from ``old_ex.sched``.

    The O(|delta|) lane of DESIGN.md §11: only the changed values reach the
    device, into a clone (the sharded class: only the dirty positions'
    values). Same contract as ``repaired_executor``."""
    slots = np.asarray(slots, np.int64)
    vals = np.asarray(vals)
    if isinstance(old_ex, ShardedScheduleExecutor):
        return ShardedScheduleExecutor._value_patched(old_ex, new_sched, slots, vals)
    if isinstance(old_ex, ScheduleExecutor):
        return ScheduleExecutor._value_patched(old_ex, new_sched, slots, vals)
    raise TypeError(f"unsupported executor type: {type(old_ex).__name__}")


# ---------------------------------------------------------------------------
# The caching and tuning entry points live in ``repro_torch.tuning``; the
# JAX package's ``core.executor`` forwards them, and so does this module.
# They resolve on first access (PEP 562), so importing this module never
# loads the tuning package, and ``tuning.registry``, which imports the
# executor classes above, makes no import cycle.
# ---------------------------------------------------------------------------

_TUNING_EXPORTS = {
    "graph_fingerprint": "repro_torch.tuning.registry",
    "mesh_fingerprint": "repro_torch.tuning.registry",
    "device_fingerprint": "repro_torch.tuning.registry",
    "clear_caches": "repro_torch.tuning.registry",
    "get_schedule": "repro_torch.tuning.registry",
    "get_spmm_schedules": "repro_torch.tuning.registry",
    "get_executor": "repro_torch.tuning.registry",
    "executor_for_schedule": "repro_torch.tuning.registry",
    "release_graph": "repro_torch.tuning.registry",
    "TunedConfig": "repro_torch.tuning.space",
    "default_sweep": "repro_torch.tuning.space",
    "sharded_sweep": "repro_torch.tuning.space",
    "sharded_device_counts": "repro_torch.tuning.space",
    "density_matched_k": "repro_torch.tuning.space",
    "autotune": "repro_torch.tuning.runner",
    "autotuned_executor": "repro_torch.tuning.runner",
    "warm_tuned_executor": "repro_torch.tuning.runner",
    "time_call": "repro_torch.tuning.runner",
}

__getattr__, __dir__ = lazy_exports(__name__, _TUNING_EXPORTS, globals())
