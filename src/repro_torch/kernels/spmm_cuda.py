"""AWB-balanced SpMM on Hopper — the counterpart of ``repro.kernels.spmm_pallas``.

``spmm_balanced(steps, b)`` computes ``C = A @ B`` for sparse A given as a
converged ``Schedule`` with two hand-written CUDA kernels
(``csrc/spmm_balanced.cu``, whose header note gives the design and bound):

* ``spmm_window`` — a group of lanes (a warp, or 16 or 8 of its lanes) takes
  one whole step: it gathers the step's live B rows with 16-byte loads (a
  column panel at a time when B outgrows L2), sums each run of one output
  row in registers in f32 and writes the run's sum as one row of the
  partial output ``[n_parts, kdim]``;
* ``spmm_epilogue`` — folds the partials into matrix rows through a
  row → partial CSR built at upload (the adder tree for evil-row chunks and
  for rows whose sums span steps), in a fixed order, optionally
  un-permuting rows of a reordered schedule.

``kernel_plan`` derives at upload, on the host, what the kernels need beyond
the schedule's own arrays: one 8-byte record per live slot, each step's
live slots and first partial, and the epilogue's CSR. Only these are
uploaded (``DeviceSteps``); the plain versions read the same records.
After a streaming update, ``splice_plan`` and ``value_patch_plan`` derive
the new plan from the old one, planning only the steps that changed.
``make_spmm_fn`` makes the product differentiable in B: its backward runs the
same two kernels on a schedule built for Aᵀ.
``lane_mapping`` picks the lanes' layout from kdim, dtype and B's size.

``acc_dtype=torch.bfloat16`` selects the kernels' bf16-accumulate variant,
the port of the executor's ``bf16_accumulate`` option: B and the slot
values are rounded to bf16, and so is each product and each running sum
after every add, in the window kernel and in the epilogue alike. The
window then takes B in bf16 (``window_operand`` rounds an f32 B once,
before the launch), multiplies and adds packed bf16 pairs, and writes bf16
partials, which the epilogue sums in bf16. ``bf16_rounding_check`` runs
the card's exhaustive check that the packed operations round as the
written-out f32 sequence of the plain versions.

Each wrapper takes its kernel's plain PyTorch version (``*_plain``, which
computes the same partials) only for a tensor on the CPU. A CUDA tensor
launches the kernel or raises. ``LAUNCHES`` counts launches per kernel, so a
run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import csc as fmt
from repro_torch.core.schedule import Schedule
from repro_torch.core.spmm import GATHER_ELEMS
from repro_torch.kernels import _build

#: the CUDA source of both kernels, relative to the repository root
SOURCE = "src/repro_torch/kernels/csrc/spmm_balanced.cu"

#: kernel launches since the last ``reset_launches()``, by kernel name (the
#: ``_bf16acc`` entries count the bf16-accumulate variant)
LAUNCHES = {"spmm_balanced": 0, "spmm_epilogue": 0,
            "spmm_balanced_bf16acc": 0, "spmm_epilogue_bf16acc": 0}

#: B's and C's dtypes, and the accumulator's (bf16: rounded after every
#: multiply and add)
_DTYPES = (torch.float32, torch.bfloat16)
#: lanes a step may take, and 16-byte vectors a lane may own, in the kernel
GROUP_WIDTHS = (32, 16, 8)
MAX_VECTORS = 4
#: an H100's L2 cache and line (bytes): a B larger than the cache is
#: gathered one line-wide column panel at a time, so each panel's slice of B
#: stays in L2 while every step reads it
L2_BYTES = 50 * 2**20
LINE_BYTES = 128
#: lines a panel of the bf16-accumulate window (each of 8 lanes owns 2
#: vectors): chip_smoke.py phase 6b times it beside 1-line panels and one
#: pass, which were slower on reddit at kdim 128 and 512
BF16ACC_PANEL_LINES = 2


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class DeviceSteps(NamedTuple):
    """The arrays the kernels read (``kernel_plan``'s), on one device."""

    slots: torch.Tensor  # [n_live, 2] int32: {B row | run start << 31, val bits}
    slot_ptr: torch.Tensor  # [n_steps + 1] int32: live slots of step s
    part_ptr: torch.Tensor  # [n_steps + 1] int32: first partial of step s
    epi_ptr: torch.Tensor  # [m + 1] int32: partials of output row i
    epi_part: torch.Tensor  # [n_parts] int32, ascending within each row
    shape: Tuple[int, int]
    n_parts: int

    @property
    def n_steps(self) -> int:
        return self.slot_ptr.shape[0] - 1

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in self[:5])


#: the ``kernel_plan`` arrays that are uploaded (``DeviceSteps``' fields);
#: ``part_row`` stays on the host for ``splice_plan``
DEVICE_FIELDS = ("slots", "slot_ptr", "part_ptr", "epi_ptr", "epi_part")


def kernel_plan(sched: Schedule, steps=None) -> dict:
    """Host arrays the kernels need beyond the schedule's own, for the
    ascending step indices ``steps`` (None: every step; a sharded
    executor plans each mesh position's step range apart).

    * ``slot_ptr``: step s's live slots, its first ``slot_ptr[s+1] -
      slot_ptr[s]`` (1 + its last slot with ``val != 0``; 0 for an
      all-padding step). Padding is a step's tail and is left out.
    * ``slots``: one 8-byte record per live slot, step by step: the global B
      row ``min(cblk * CB + lcol, n - 1)`` with bit 31 set where a run of
      equal ``lrow`` starts, and ``val``'s bits.
    * ``part_ptr``: step s's first partial. A partial is one run, so step s
      has ``part_ptr[s+1] - part_ptr[s]`` of them, numbered in slot order.
    * ``epi_ptr``/``epi_part``: the CSR from output row to the partials of
      its output slots (``row_map[win * R + lrow]``), ascending.
    * ``part_row``: each partial's output row (-1: none), which the kernels
      do not read; ``splice_plan`` carries it over for reused steps.

    Steps may come in any order: no partial takes sums from two steps."""
    return _plan_from_records(*step_records(sched, steps), sched.shape[0])


def step_records(sched: Schedule, steps=None):
    """``kernel_plan``'s per-step pieces for the ascending step indices
    ``steps`` (None: every step): the steps' slot records in step order,
    each step's live slots and partials, and each partial's output row."""
    (_, n), k = sched.shape, sched.nnz_per_step
    if n > 2**31 - 1:
        raise ValueError(f"B has {n} rows; a slot record holds a 31-bit row")
    val = sched.val.reshape(-1, k)
    lrow = sched.local_row.reshape(-1, k)
    lcol = sched.local_col.reshape(-1, k)
    win, cblk = sched.win_id, sched.col_block
    if steps is not None:
        steps = np.asarray(steps, np.int64)
        val, lrow, lcol, win, cblk = (x[steps] for x in (val, lrow, lcol, win, cblk))
    nz = val != 0
    live = np.where(nz.any(axis=1), k - np.argmax(nz[:, ::-1], axis=1), 0)
    in_live = np.arange(k)[None, :] < live[:, None]
    start = in_live.copy()
    start[:, 1:] &= lrow[:, 1:] != lrow[:, :-1]
    gcol = np.minimum(cblk.astype(np.int64)[:, None] * sched.cols_per_block + lcol,
                      n - 1)
    head = (gcol | start.astype(np.int64) << 31).astype(np.uint32).view(np.int32)
    slots = np.stack([head[in_live], val[in_live].view(np.int32)], axis=1)
    step, slot = np.nonzero(start)  # partials in order
    part_row = sched.row_map[win[step].astype(np.int64) * sched.rows_per_window
                             + lrow[step, slot]]
    return slots, live, start.sum(axis=1), part_row


def _plan_from_records(slots, live, n_part, part_row, m: int) -> dict:
    """The plan of steps with these records, live slots and partials per
    step, and partials' output rows: the step pointers by prefix sums, the
    epilogue's CSR by a stable sort of the partials on their rows."""
    kept = np.flatnonzero(part_row >= 0)
    order = np.argsort(part_row[kept], kind="stable")
    rows = np.bincount(part_row[kept], minlength=m)
    return {
        "slots": slots,
        "slot_ptr": np.concatenate([[0], np.cumsum(live)]).astype(np.int32),
        "part_ptr": np.concatenate([[0], np.cumsum(n_part)]).astype(np.int32),
        "epi_ptr": np.concatenate([[0], np.cumsum(rows)]).astype(np.int32),
        "epi_part": kept[order].astype(np.int32),
        "part_row": np.asarray(part_row, np.int32),
    }


def splice_plan(old: dict, new_sched: Schedule, step_src, steps=None) -> dict:
    """``kernel_plan(new_sched, steps)`` from the old schedule's plan and a
    repair's ``step_src`` (per planned new step, the step of ``old`` whose
    slots it carries verbatim, or -1): a reused step keeps its records, its
    run starts and its partials' output rows (a repair remaps ``row_map``
    to the new windows without changing the rows it names), so only
    re-emitted steps are planned afresh. Reused steps whose sources follow
    one another are copied as one range. Equal to the full plan, array for
    array. ``steps`` (None: every new step) are the ascending new steps the
    plan covers, one per ``step_src`` entry — a mesh position's range."""
    src = np.asarray(step_src, np.int64)
    s_new = src.shape[0]
    if steps is None:
        if s_new != new_sched.n_steps:
            raise ValueError("step_src does not match the repaired schedule")
        steps = np.arange(s_new)
    elif len(steps) != s_new:
        raise ValueError("step_src does not match the planned steps")
    reused = src >= 0
    fresh = np.flatnonzero(~reused)
    f_slots, f_live, f_part, f_rows = step_records(
        new_sched, np.asarray(steps, np.int64)[fresh])
    o_sp = old["slot_ptr"].astype(np.int64)
    o_pp = old["part_ptr"].astype(np.int64)
    live = np.empty(s_new, np.int64)
    n_part = np.empty(s_new, np.int64)
    live[reused] = np.diff(o_sp)[src[reused]]
    n_part[reused] = np.diff(o_pp)[src[reused]]
    live[fresh], n_part[fresh] = f_live, f_part
    sp = np.concatenate([[0], np.cumsum(live)])
    pp = np.concatenate([[0], np.cumsum(n_part)])
    # ranges: a run of reused steps with consecutive sources, or of fresh steps
    cut = np.ones(s_new, bool)
    cut[1:] = (reused[1:] != reused[:-1]) | (reused[1:] & (src[1:] != src[:-1] + 1))
    lo = np.flatnonzero(cut)
    hi = np.append(lo[1:], s_new)
    slots = np.empty((int(sp[-1]), 2), np.int32)
    rows = np.empty(int(pp[-1]), np.int32)
    fs = fp = 0
    for a, b in zip(lo.tolist(), hi.tolist()):
        ns, np_ = sp[b] - sp[a], pp[b] - pp[a]
        if reused[a]:
            s0, p0 = o_sp[src[a]], o_pp[src[a]]
            slots[sp[a]:sp[b]] = old["slots"][s0:s0 + ns]
            rows[pp[a]:pp[b]] = old["part_row"][p0:p0 + np_]
        else:
            slots[sp[a]:sp[b]] = f_slots[fs:fs + ns]
            rows[pp[a]:pp[b]] = f_rows[fp:fp + np_]
            fs, fp = fs + ns, fp + np_
    return _plan_from_records(slots, live, n_part, rows, new_sched.shape[0])


def concat_plans(plans) -> dict:
    """One plan of consecutive steps from the plans of consecutive step
    ranges (a sharded executor's positions; None: an empty range), with
    the fields ``splice_plan`` reads of an old plan: the records, the step
    pointers and each partial's output row."""
    plans = [p for p in plans if p is not None]
    if not plans:
        zero = np.zeros(1, np.int32)
        return {"slots": np.zeros((0, 2), np.int32), "slot_ptr": zero,
                "part_ptr": zero, "part_row": np.zeros(0, np.int32)}

    def ptrs(key):
        off = np.cumsum([0] + [int(p[key][-1]) for p in plans[:-1]])
        return np.concatenate([[0]] + [p[key][1:].astype(np.int64) + o
                                       for p, o in zip(plans, off)]).astype(np.int32)

    return {"slots": np.concatenate([p["slots"] for p in plans]),
            "slot_ptr": ptrs("slot_ptr"), "part_ptr": ptrs("part_ptr"),
            "part_row": np.concatenate([p["part_row"] for p in plans])}


def value_patch_plan(plan: dict, nnz_per_step: int, slots, vals):
    """``(plan, records)`` after the flat schedule ``slots`` take the
    non-zero ``vals``: the plan with a copy of the records holding the new
    values' bits, and the indices of the records that changed
    (``slot_ptr[slot // K] + slot % K``). Every other array is shared. A
    non-zero slot patched to a non-zero value stays in its step's live
    prefix, so the layout holds; anything else raises."""
    slots = np.asarray(slots, np.int64)
    vals = np.asarray(vals, np.float32)
    if not np.all(vals != 0):
        raise ValueError("a value patch to zero changes the live slots; the "
                         "repair lane takes removals")
    step, off = np.divmod(slots, nnz_per_step)
    ptr = plan["slot_ptr"]
    if np.any(off >= ptr[step + 1] - ptr[step]):
        raise ValueError("a patched slot lies outside its step's live slots")
    rec = ptr[step].astype(np.int64) + off
    records = plan["slots"].copy()
    records[rec, 1] = vals.view(np.int32)
    return dict(plan, slots=records), rec


def lane_mapping(kdim: int, dtype, aligned: bool = True, rows: int = 0,
                 acc_dtype=torch.float32):
    """The window kernel's lanes for B ``[rows, kdim]`` of ``dtype``
    (bf16 under ``acc_dtype=torch.bfloat16``, ``window_operand``): returns
    ``(vec, gw, nc, panels)``. A lane gathers ``vec`` elements at once (16
    bytes when ``kdim`` and B's address allow it, else 1) and owns ``nc``
    such vectors; ``gw`` lanes take a step; a step's row is cut into
    ``panels`` of ``gw * nc * vec`` columns, each panel a pass over all
    steps. When B is larger than L2 and its rows are whole lines, a panel is
    one line (8 lanes of 16 bytes), so the panel's slice of B stays in L2;
    under bf16 accumulation ``BF16ACC_PANEL_LINES`` lines (each lane owns
    that many vectors), where the row holds a whole number of them.
    Otherwise: fewest panels first (each one walks the steps again), then
    fewest idle lanes, then the widest group."""
    elt = torch.empty((), dtype=dtype).element_size()
    vec = 16 // elt
    if not aligned or kdim % vec:
        vec = 1
    if vec > 1 and kdim * elt % LINE_BYTES == 0 and rows * kdim * elt > L2_BYTES:
        lines = BF16ACC_PANEL_LINES if _check_acc(acc_dtype) and (
            kdim * elt % (BF16ACC_PANEL_LINES * LINE_BYTES) == 0) else 1
        return vec, LINE_BYTES // 16, lines, kdim * elt // (lines * LINE_BYTES)
    nv = -(-kdim // vec)
    best = None
    for gw in GROUP_WIDTHS:
        for nc in range(1, MAX_VECTORS + 1):
            panels = -(-nv // (gw * nc))
            idle = panels * gw * nc - nv
            key = (panels, idle, -gw, nc)
            if best is None or key < best[0]:
                best = (key, (vec, gw, nc, panels))
    return best[1]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("spmm_balanced")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.awb_spmm_window.argtypes = [p, p, p, i, p] + [i] * 6 + [p, p]
    lib.awb_spmm_window.restype = i
    lib.awb_spmm_epilogue.argtypes = [p, p, p, p, i, i, p, i, i, p]
    lib.awb_spmm_epilogue.restype = i
    lib.awb_bf16_rounding_check.argtypes = [p, p]
    lib.awb_bf16_rounding_check.restype = i
    return lib


def _check_acc(acc_dtype) -> bool:
    """Whether ``acc_dtype`` asks for the bf16-accumulate variant."""
    if acc_dtype not in _DTYPES:
        raise ValueError(f"accumulator dtype {acc_dtype}; the kernels accumulate "
                         "in float32 or bfloat16")
    return acc_dtype == torch.bfloat16


def window_operand(b: torch.Tensor, acc_dtype=torch.float32) -> torch.Tensor:
    """B as the window kernel gathers it: under bf16 accumulation an f32 B
    rounded to bf16 once (the executor's own ``b.astype(acc)``, a plain
    elementwise cast, so each gathered element is the value the plain
    version rounds per gather); else B itself."""
    if _check_acc(acc_dtype) and b.dtype == torch.float32:
        return b.to(torch.bfloat16)
    return b


def partial_dtype(acc_dtype) -> torch.dtype:
    """The partial output's dtype: bf16 rows under bf16 accumulation, else
    f32."""
    return torch.bfloat16 if _check_acc(acc_dtype) else torch.float32


def _check_part(part: torch.Tensor, acc_dtype) -> None:
    want = partial_dtype(acc_dtype)
    if part.dtype != want:
        raise ValueError(f"partial output is {part.dtype}; accumulating in "
                         f"{acc_dtype} the epilogue takes {want} partials")


def _check_cuda(steps: DeviceSteps, x: torch.Tensor, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what} is on {x.device}; the kernel runs on CUDA")
    if steps.slots.device != x.device:
        raise ValueError(
            f"{what} is on {x.device} but the schedule is on {steps.slots.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


# ---------------------------------------------------------------------------
# The window kernel
# ---------------------------------------------------------------------------


def spmm_window(steps: DeviceSteps, b: torch.Tensor, *, ktile: int = 128,
                acc_dtype=torch.float32):
    """Partial output ``[n_parts, kdim]`` in ``partial_dtype(acc_dtype)``
    (f32, or bf16 under bf16 accumulation): row p is the sum of
    ``val * B[col]`` over the p-th run of equal ``lrow`` among the live
    slots of its step, accumulated in ``acc_dtype``. Under bf16
    accumulation an f32 B is rounded to bf16 first (``window_operand``).
    Padding slots are skipped, so a non-finite B row is never multiplied
    into a padding slot. ``ktile`` is accepted as a hint and not used: the
    kernel lays out its columns from kdim, dtype and B's size
    (``lane_mapping``)."""
    del ktile
    _check_acc(acc_dtype)
    if b.device.type == "cpu":
        return spmm_window_plain(steps, b, acc_dtype=acc_dtype)
    _check_cuda(steps, b, "B")
    n = steps.shape[1]
    if b.dim() != 2 or b.shape[0] != n:
        raise ValueError(f"B has shape {tuple(b.shape)}; the schedule needs [{n}, k]")
    if b.dtype not in _DTYPES:
        raise ValueError(f"B is {b.dtype}; the kernel takes float32 or bfloat16")
    b = window_operand(b, acc_dtype)
    return _window(steps, b, lane_mapping(b.shape[1], b.dtype, b.data_ptr() % 16 == 0,
                                          n, acc_dtype), acc_dtype)


def _window(steps: DeviceSteps, b: torch.Tensor, mapping,
            acc_dtype=torch.float32) -> torch.Tensor:
    """Launch the window kernel on a checked B with the lanes ``mapping``
    (``lane_mapping``'s tuple); under bf16 accumulation B must be bf16
    already (``window_operand``)."""
    bf16acc = _check_acc(acc_dtype)
    if bf16acc and b.dtype != torch.bfloat16:
        raise ValueError(f"B is {b.dtype}; the bf16-accumulate window gathers "
                         "bfloat16 (window_operand)")
    vec, gw, nc, _ = mapping
    kdim = b.shape[1]
    out = torch.empty((steps.n_parts, kdim), dtype=partial_dtype(acc_dtype),
                      device=b.device)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        LAUNCHES["spmm_balanced_bf16acc" if bf16acc else "spmm_balanced"] += 1
        err = _lib().awb_spmm_window(
            steps.slots.data_ptr(), steps.slot_ptr.data_ptr(),
            steps.part_ptr.data_ptr(), steps.n_steps, b.data_ptr(),
            int(b.dtype == torch.bfloat16), int(bf16acc), kdim, vec, gw, nc,
            out.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"awb_spmm_window launch failed: cudaError {err}")
    return out


def spmm_window_plain(steps: DeviceSteps, b: torch.Tensor, *,
                      acc_dtype=torch.float32) -> torch.Tensor:
    """Plain version of the window kernel on the same slot records: gather
    each live slot's B row, scale it by the slot's value and ``index_add_``
    it into its partial, in f32. Partials are numbered by run in slot order,
    so a slot's partial is the count of run starts up to it, less one. Runs
    over chunks of slots so the ``[slots, kdim]`` intermediate stays
    bounded. With ``acc_dtype=torch.bfloat16`` it takes the kernel's
    rounding sequence instead (``_window_plain_bf16``)."""
    if _check_acc(acc_dtype):
        return _window_plain_bf16(steps, b)
    kdim = b.shape[1]
    out = torch.zeros((steps.n_parts, kdim), dtype=torch.float32, device=b.device)
    n_live = steps.slots.shape[0]
    chunk = max(1, GATHER_ELEMS // max(1, kdim))
    last = -1  # the partial of the slot before the chunk
    for lo in range(0, n_live, chunk):
        head, bits = steps.slots[lo:lo + chunk].unbind(dim=1)
        part = last + torch.cumsum(head < 0, dim=0)
        last = int(part[-1])
        g = b[head & 0x7FFFFFFF].float() * bits.view(torch.float32)[:, None]
        out.index_add_(0, part, g)
    return out


def _positions(index: torch.Tensor, first: torch.Tensor) -> list:
    """Indices grouped by position ``index - first`` within their run, as
    ``[(position's indices)]`` in ascending position; no run appears twice
    in a group, so a group's updates touch distinct rows."""
    pos = index - first
    order = torch.argsort(pos, stable=True)
    ends = torch.bincount(pos).cumsum(0).tolist() if pos.numel() else []
    return [order[lo:hi] for lo, hi in zip([0] + ends[:-1], ends)]


def _window_plain_bf16(steps: DeviceSteps, b: torch.Tensor) -> torch.Tensor:
    """The bf16-accumulate window in plain PyTorch, in the kernel's rounding
    sequence: each run's slots are added in slot order, one position of
    every run at a time, as ``sum = bf16(sum + bf16(bf16(B) * bf16(val)))``.
    Returns the bf16 partials."""
    kdim = b.shape[1]
    head, bits = steps.slots.unbind(dim=1)
    start = head < 0
    part = torch.cumsum(start, dim=0) - 1
    idx = torch.arange(head.numel(), device=b.device)
    first = torch.cummax(torch.where(start, idx, 0), dim=0).values
    rows = (head & 0x7FFFFFFF).long()
    val = bits.view(torch.float32).to(torch.bfloat16)
    out = torch.zeros((steps.n_parts, kdim), dtype=torch.bfloat16, device=b.device)
    chunk = max(1, GATHER_ELEMS // max(1, kdim))
    for group in _positions(idx, first):
        for lo in range(0, group.numel(), chunk):
            s = group[lo:lo + chunk]
            p = part[s]
            out[p] = out[p] + b[rows[s]].to(torch.bfloat16) * val[s][:, None]
    return out


# ---------------------------------------------------------------------------
# The epilogue kernel
# ---------------------------------------------------------------------------


def spmm_epilogue(steps: DeviceSteps, part: torch.Tensor, dtype,
                  row_unperm: torch.Tensor | None = None, *,
                  acc_dtype=torch.float32) -> torch.Tensor:
    """Matrix rows ``[m, kdim]`` in ``dtype`` from the partial output: row
    ``i`` sums, in ascending order, the partials of row ``row_unperm[i]``
    (or ``i``), in ``acc_dtype`` (bf16: rounded after every add). The
    partials' dtype must be ``partial_dtype(acc_dtype)``. The kernel reads
    16-byte vectors of ``part`` (4 f32 or 8 bf16 columns) when kdim is a
    multiple of that and ``part`` and the output are 16-byte aligned, else
    single elements."""
    bf16acc = _check_acc(acc_dtype)
    _check_part(part, acc_dtype)
    if part.device.type == "cpu":
        return spmm_epilogue_plain(steps, part, dtype, row_unperm, acc_dtype=acc_dtype)
    _check_cuda(steps, part, "the partial output")
    m = steps.shape[0]
    if part.dim() != 2 or part.shape[0] != steps.n_parts:
        raise ValueError(f"partial output has shape {tuple(part.shape)}; the "
                         f"epilogue needs [{steps.n_parts}, k]")
    if dtype not in _DTYPES:
        raise ValueError(f"output dtype {dtype}; the kernel writes float32 or bfloat16")
    unperm_ptr = None
    if row_unperm is not None:
        _check_cuda(steps, row_unperm, "row_unperm")
        if row_unperm.dtype != torch.int32 or row_unperm.shape != (m,):
            raise ValueError(f"row_unperm must be int32 [{m}]")
        unperm_ptr = row_unperm.data_ptr()
    kdim = part.shape[1]
    out = torch.empty((m, kdim), dtype=dtype, device=part.device)
    with torch.cuda.device(part.device):
        stream = torch.cuda.current_stream().cuda_stream
        LAUNCHES["spmm_epilogue_bf16acc" if bf16acc else "spmm_epilogue"] += 1
        err = _lib().awb_spmm_epilogue(
            part.data_ptr(), steps.epi_ptr.data_ptr(), steps.epi_part.data_ptr(),
            unperm_ptr, m, kdim, out.data_ptr(), int(dtype == torch.bfloat16),
            int(bf16acc), stream,
        )
    if err:
        raise RuntimeError(f"awb_spmm_epilogue launch failed: cudaError {err}")
    return out


def spmm_epilogue_plain(steps: DeviceSteps, part: torch.Tensor, dtype,
                        row_unperm: torch.Tensor | None = None, *,
                        acc_dtype=torch.float32) -> torch.Tensor:
    """Plain version of the epilogue: ``index_add_`` of each row's partials
    into it in f32, then the un-permutation and the cast. In bf16 it adds
    each row's partials in ascending order, one position of every row at a
    time, rounding after each add as the kernel does."""
    _check_part(part, acc_dtype)
    m = steps.shape[0]
    rows = torch.repeat_interleave(
        torch.arange(m, device=part.device), steps.epi_ptr.diff().long())
    if _check_acc(acc_dtype):
        out = torch.zeros((m, part.shape[1]), dtype=torch.bfloat16,
                          device=part.device)
        q = torch.arange(rows.numel(), device=part.device)
        for group in _positions(q, steps.epi_ptr[:-1].long()[rows]):
            r = rows[group]
            out[r] = out[r] + part[steps.epi_part[group].long()]
    else:
        out = torch.zeros((m, part.shape[1]), dtype=torch.float32,
                          device=part.device)
        out.index_add_(0, rows, part[steps.epi_part.long()])
    if row_unperm is not None:
        out = out[row_unperm.long()]
    return out.to(dtype)


def bf16_rounding_check(device) -> Tuple[int, int]:
    """The card's exhaustive check behind the bf16-accumulate kernels:
    over all 2^32 pairs of bf16 bit patterns, how many times
    ``mul.rn.bf16x2`` and ``add.rn.bf16x2`` differ from the written-out
    f32 sequence of the plain versions (round the f32 product or sum to
    bf16; a NaN equals any NaN). Returns ``(multiply, add)`` mismatches,
    which must both be 0. Runs on a CUDA ``device`` only."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the rounding check runs on CUDA, not {device}")
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().awb_bf16_rounding_check(counts.data_ptr(), stream)
    if err:
        raise RuntimeError(f"awb_bf16_rounding_check launch failed: cudaError {err}")
    mul, add = counts.tolist()
    return mul, add


# ---------------------------------------------------------------------------
# C = A @ B
# ---------------------------------------------------------------------------


def _steps_for(sched_or_steps, device) -> DeviceSteps:
    if isinstance(sched_or_steps, Schedule):
        from repro_torch.core.executor import device_step_arrays

        return device_step_arrays(sched_or_steps, device)
    return sched_or_steps


def spmm_balanced(sched_or_steps, b: torch.Tensor, *, ktile: int = 128,
                  row_unperm: torch.Tensor | None = None,
                  acc_dtype=torch.float32) -> torch.Tensor:
    """C = A @ B through the converged schedule (a ``Schedule``, uploaded
    once per device and memoized, or its ``DeviceSteps``), in ``b``'s
    dtype, accumulated in ``acc_dtype`` (f32, or bf16 rounded after every
    multiply and add)."""
    steps = _steps_for(sched_or_steps, b.device)
    part = spmm_window(steps, b, ktile=ktile, acc_dtype=acc_dtype)
    return spmm_epilogue(steps, part, b.dtype, row_unperm, acc_dtype=acc_dtype)


def spmm_balanced_plain(sched_or_steps, b: torch.Tensor, *,
                        row_unperm: torch.Tensor | None = None,
                        acc_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of ``spmm_balanced`` on any device."""
    steps = _steps_for(sched_or_steps, b.device)
    part = spmm_window_plain(steps, b, acc_dtype=acc_dtype)
    return spmm_epilogue_plain(steps, part, b.dtype, row_unperm, acc_dtype=acc_dtype)


# ---------------------------------------------------------------------------
# Differentiable wrapper: d(A@B)/dB = Aᵀ @ dC, served by a second schedule
# built for Aᵀ (the graph is static, so both schedules amortize like the
# paper's converged configuration). A's values are treated as constants
# (the normalized adjacency is not trained).
# ---------------------------------------------------------------------------


def transpose_coo(a: fmt.COO) -> fmt.COO:
    return fmt.transpose_coo(a)


class SpmmFn:
    """``f(b) = A @ b``, differentiable in ``b``: the kernels on A's
    schedule forward and on Aᵀ's backward (``make_spmm_fn``). Holds both
    schedules and their ``DeviceSteps`` per device, so a training loop plans
    and uploads each once, whatever the executor cache evicts meanwhile."""

    def __init__(self, sched: Schedule, sched_t: Schedule, *, ktile: int,
                 backend: str | None):
        self.sched, self.sched_t = sched, sched_t
        self.ktile = ktile
        self.backend = backend
        self._steps: dict = {}

    def device_steps(self, transpose: bool, device) -> DeviceSteps:
        """A's (or, with ``transpose``, Aᵀ's) ``DeviceSteps`` on ``device``:
        ``executor.device_step_arrays``' upload, held here after the first
        call."""
        from repro_torch.core.executor import device_step_arrays

        key = (transpose, str(device))
        steps = self._steps.get(key)
        if steps is None:
            steps = device_step_arrays(self.sched_t if transpose else self.sched,
                                       device)
            self._steps[key] = steps
        return steps

    def product(self, b: torch.Tensor, transpose: bool = False) -> torch.Tensor:
        """``A @ b`` (or ``Aᵀ @ b``) on ``b``'s device, by the backend
        rule of ``ops.spmm``: the kernels for a CUDA tensor unless
        ``backend="torch"``, the plain version for a CPU tensor."""
        steps = self.device_steps(transpose, b.device)
        if (self.backend or ("cuda" if b.is_cuda else "torch")) == "cuda":
            return spmm_balanced(steps, b.contiguous(), ktile=self.ktile)
        return spmm_balanced_plain(steps, b)

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return _AwbSpmm.apply(b, self)


class _AwbSpmm(torch.autograd.Function):
    """C = A @ B with dB = Aᵀ @ dC. A is a constant: no gradient reaches
    its values."""

    @staticmethod
    def forward(ctx, b: torch.Tensor, fn: SpmmFn) -> torch.Tensor:
        ctx.fn = fn
        return fn.product(b)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dc: torch.Tensor):
        # autograd may hand over a stride-0 expansion (``out.sum()``) or a
        # strided view: the window kernel reads contiguous rows
        return ctx.fn.product(dc.contiguous(), transpose=True), None


def make_spmm_fn(a: fmt.COO, *, nnz_per_step: int = 256,
                 rows_per_window: int = 64, ktile: int = 128,
                 schedules: Tuple[Schedule, Schedule] | None = None,
                 routing: str = "auto", backend: str | None = None) -> SpmmFn:
    """Returns a differentiable ``f(b) = A @ b`` backed by the SpMM kernels
    with schedules for A and Aᵀ built once (the converged configurations).

    ``schedules`` accepts a prebuilt ``(forward, transpose)`` pair; when
    omitted, both come from the registry's fingerprint cache
    (``registry.get_spmm_schedules``), so repeated call sites on the same
    graph share one build instead of re-running it. ``routing`` keeps the
    JAX signature and is validated as ``ops.spmm`` validates it. ``backend``
    follows ``ops.spmm``: ``None`` runs the kernels on a CUDA tensor and the
    plain version on a CPU one, ``"cuda"`` the kernels, ``"torch"`` the
    plain version on any device (both ways)."""
    from repro_torch.kernels import ops

    if routing not in ops.ROUTINGS:
        raise ValueError(f"unknown routing {routing!r}; expected one of {ops.ROUTINGS}")
    if backend not in (None,) + ops.BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {ops.BACKENDS}")
    if schedules is None:
        from repro_torch.tuning.registry import get_spmm_schedules

        schedules = get_spmm_schedules(a, nnz_per_step=nnz_per_step,
                                       rows_per_window=rows_per_window)
    sched, sched_t = schedules
    return SpmmFn(sched, sched_t, ktile=ktile, backend=backend)
