"""ScheduleExecutor — the converged AWB configuration, resident on one device.

The single-device part of ``repro.core.executor``. ``ScheduleExecutor``
uploads a ``Schedule``'s arrays to its device once at construction; every
``spmm``/``forward``/``forward_batch`` call then moves only the dense
operand.

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
is unchanged.

The executor serves inference: its methods record no autograd graph.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.schedule import Schedule
from repro_torch.core.spmm import GATHER_ELEMS
from repro_torch.device import resolve_device
from repro_torch.kernels import spmm_cuda

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
    free when nothing is armed, and raises when an armed fault matches. This
    slice has the ``"upload"`` seam (host→device array upload, context
    ``device=``).

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
# LRU; each entry is (schedule, DeviceSteps, host plan).
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


def _remember(sched: Schedule, device: torch.device, steps, plan: dict) -> None:
    """Memoize ``sched``'s upload on ``device`` with its host plan."""
    key = (id(sched), str(device))
    _DEVICE_STEPS[key] = (sched, steps, plan)
    _DEVICE_STEPS.move_to_end(key)
    if len(_DEVICE_STEPS) > _DEVICE_STEPS_CAP:
        _DEVICE_STEPS.popitem(last=False)


def _device_plan(sched: Schedule, device: torch.device):
    """``(DeviceSteps, host plan)`` of ``sched`` on a resolved ``device``,
    planned and uploaded once per (schedule instance, device)."""
    hit = _DEVICE_STEPS.get((id(sched), str(device)))
    if hit is not None and hit[0] is sched:
        _DEVICE_STEPS.move_to_end((id(sched), str(device)))
        return hit[1], hit[2]
    plan = spmm_cuda.kernel_plan(sched)
    steps = _upload_plan(plan, sched.shape, device)
    _remember(sched, device, steps, plan)
    return steps, plan


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
                  new_sched: Schedule, repair):
    """``(DeviceSteps, host plan, scoped)`` of a repaired schedule from the
    old upload and plan (``spmm_cuda.splice_plan`` over the repair's
    ``step_src``); a repair that fell back to a full rebuild is planned
    and uploaded cold (``scoped`` False). When the records keep
    their layout (equal ``slot_ptr``), the moved steps' records are written
    into a clone of the old records on their device — if they are at most
    half of them and the records reach ``SCOPED_UPLOAD_MIN_BYTES`` — or the
    old records are shared when no step moved; ``scoped`` is then True.
    Otherwise the records go up whole. The small index arrays go up anew."""
    dev = old_steps.slots.device
    if repair.fell_back or repair.step_src is None:
        return (*_device_plan(new_sched, dev), False)
    plan = spmm_cuda.splice_plan(old_plan, new_sched, repair.step_src)
    src = np.asarray(repair.step_src, np.int64)
    moved = np.flatnonzero(src != np.arange(src.shape[0]))
    sp = plan["slot_ptr"]
    live = np.diff(sp)[moved].astype(np.int64)
    n_moved = int(live.sum())
    n_live = plan["slots"].shape[0]
    same_layout = np.array_equal(sp, old_plan["slot_ptr"])
    small = {k: _placed(plan[k], dev) for k in spmm_cuda.DEVICE_FIELDS[1:]}
    if same_layout and n_moved == 0:
        records, scoped = old_steps.slots, True
    elif (same_layout and 2 * n_moved <= n_live
          and plan["slots"].nbytes >= SCOPED_UPLOAD_MIN_BYTES):
        idx = _ranges(sp[moved].astype(np.int64), live)
        records, scoped = _patched_records(old_steps.slots, plan, idx), True
    else:
        records, scoped = _placed(plan["slots"], dev), False
    steps = spmm_cuda.DeviceSteps(slots=records, **small, shape=new_sched.shape,
                                  n_parts=int(plan["part_ptr"][-1]))
    return steps, plan, scoped


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


def release_device_steps(sched: Schedule, device=ALL_DEVICES) -> None:
    """Drop memoized device copies of one schedule's step arrays — on every
    device, or only on ``device`` (``None`` meaning the card)."""
    sid = id(sched)
    if device is ALL_DEVICES:
        keys = [k for k in _DEVICE_STEPS if k[0] == sid]
    else:
        key = (sid, str(resolve_device(device)))
        keys = [key] if key in _DEVICE_STEPS else []
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


class ScheduleExecutor:
    """Device-resident executor of one converged AWB schedule.

    Construction uploads the schedule to ``device`` (default: the card)
    once; ``device_bytes`` reports the resident footprint.

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
    ):
        self.sched = sched
        self.ktile = ktile
        self.bf16_accumulate = bf16_accumulate
        self.device = resolve_device(device)
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
            self._steps, self._plan = _device_plan(sched, self.device)
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
                    row_unperm=self.row_unperm)

    def _sibling(self, new_sched: Schedule) -> "ScheduleExecutor":
        """A new executor object for ``new_sched`` with this one's settings
        and row un-permutation, its device arrays still to be set."""
        new = type(self).__new__(type(self))
        new.sched = new_sched
        new.ktile = self.ktile
        new.bf16_accumulate = self.bf16_accumulate
        new.device = self.device
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
                old_ex._steps, old_ex._plan, new_sched, repair)
            _remember(new_sched, self.device, self._steps, self._plan)
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
            _remember(new_sched, self.device, self._steps, self._plan)
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

    __call__ = spmm

    @torch.no_grad()
    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Whole-GCN forward logits: every layer runs A × (X × W) here."""
        self._check_rows(x.shape[0], "features")
        params = {name: self.commit(w) for name, w in params.items()}
        return self._forward_impl(params, self.commit(x))

    @torch.no_grad()
    def forward_batch(self, params: dict, xs: torch.Tensor) -> torch.Tensor:
        """Logits of a batch of requests ``xs [B, n, f]`` → ``[B, m, c]``:
        the port of the serving engine's ``vmap`` of ``_forward_impl``. Each
        request's X·W is its own product; each layer's SpMM then runs once
        on the requests' column-stacked ``[n, B·k]`` operand."""
        if xs.dim() != 3:
            raise ValueError(f"requests must be [B, n, f]; got {tuple(xs.shape)}")
        self._check_rows(xs.shape[1], "features")
        params = {name: self.commit(w) for name, w in params.items()}
        h = self.commit(xs)
        m, n = self.sched.shape
        bsz = xs.shape[0]
        n_layers = len(params)
        for i in range(n_layers):
            xw = h @ params[f"w{i}"]  # [B, n, k]
            k = xw.shape[-1]
            y = self._spmm_impl(xw.permute(1, 0, 2).reshape(n, bsz * k))
            h = y.reshape(m, bsz, k).permute(1, 0, 2)
            if i < n_layers - 1:
                h = torch.relu(h)
        return h.contiguous()

    def _forward_impl(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        h = x
        n_layers = len(params)
        for i in range(n_layers):
            h = self._spmm_impl(h @ params[f"w{i}"])  # A × (X × W)
            if i < n_layers - 1:
                h = torch.relu(h)
        return h

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
        """Fused-gather routing: B-row gather per slot, one ``index_add_``
        into final output rows (row_map precomposed), chunked over the slot
        stream."""
        m, _ = self.sched.shape
        acc = self._acc_dtype
        bf = b.to(acc)
        out = torch.zeros((m, b.shape[-1]), dtype=acc, device=b.device)
        for i in range(self._n_chunks):
            g = bf.index_select(0, self._gcol[i]) * self._val[i].to(acc)[:, None]
            out.index_add_(0, self._tgt[i], g)
        if self._unperm is not None:
            out = out.index_select(0, self._unperm)
        return out.to(b.dtype)

    def _onehot_impl(self, b: torch.Tensor) -> torch.Tensor:
        """Dense-routing emulation: each step's two one-hot contractions
        against its [CB, kdim] B-panel, then the scatter epilogue."""
        m, n = self.sched.shape
        k = self.sched.nnz_per_step
        r = self.sched.rows_per_window
        cb = self.sched.cols_per_block
        kdim = b.shape[-1]
        acc = self._acc_dtype
        dev = b.device
        ncb = -(-n // cb)
        bp = torch.zeros((ncb * cb, kdim), dtype=acc, device=dev)
        bp[:n] = b.to(acc)
        bp = bp.reshape(ncb, cb, kdim)
        s = self._onehot
        ar_cb = torch.arange(cb, device=dev)
        ar_r = torch.arange(r, device=dev)
        out_perm = torch.zeros((self.sched.n_windows, r, kdim), dtype=acc, device=dev)
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
        if self._unperm is not None:
            out = out.index_select(0, self._unperm)
        return out.to(b.dtype)


def repaired_executor(old_ex, new_sched: Schedule, repair):
    """Executor for a repaired schedule (``schedule.repair_schedule``),
    reusing ``old_ex``'s device arrays wherever the repair left steps
    untouched — the scoped re-upload path of DESIGN.md §11.

    Dispatches on the old executor's class; always returns a **new**
    executor and never mutates ``old_ex``, so the serving tier can swap
    atomically while in-flight batches finish on the old one. Its device
    arrays equal a cold build's on ``new_sched`` with the same arguments."""
    if isinstance(old_ex, ScheduleExecutor):
        return ScheduleExecutor._from_repair(old_ex, new_sched, repair)
    raise TypeError(f"unsupported executor type: {type(old_ex).__name__}")


def value_patched_executor(old_ex, new_sched: Schedule, slots, vals):
    """Executor for a schedule produced by ``schedule.value_patch_schedule``
    — structure unchanged, only ``val[slots]`` differ from ``old_ex.sched``.

    The O(|delta|) lane of DESIGN.md §11: only the changed values reach the
    device, into a clone. Same contract as ``repaired_executor``."""
    slots = np.asarray(slots, np.int64)
    vals = np.asarray(vals)
    if isinstance(old_ex, ScheduleExecutor):
        return ScheduleExecutor._value_patched(old_ex, new_sched, slots, vals)
    raise TypeError(f"unsupported executor type: {type(old_ex).__name__}")
