"""AWB-balanced SpMM on Hopper — the counterpart of ``repro.kernels.spmm_pallas``.

``spmm_balanced(steps, b)`` computes ``C = A @ B`` for sparse A given as a
converged ``Schedule`` with two hand-written CUDA kernels
(``csrc/spmm_balanced.cu``, whose header note gives the design and bound):

* ``spmm_window`` — one thread block per (output window, column tile) loops
  over the window's contiguous steps and accumulates the window in shared
  memory in f32; it writes the live slots of the permuted output;
* ``spmm_epilogue`` — folds the permuted output into matrix rows through a
  row → slot CSR built at upload (the adder tree for evil-row chunks), in a
  fixed order, optionally un-permuting rows of a reordered schedule.

Each wrapper takes its kernel's plain PyTorch version (``*_plain``) only
for a tensor on the CPU. A CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts launches per kernel, so a run can show that its path
went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.schedule import Schedule
from repro_torch.core.spmm import GATHER_ELEMS
from repro_torch.kernels import _build

#: the CUDA source of both kernels, relative to the repository root
SOURCE = "src/repro_torch/kernels/csrc/spmm_balanced.cu"

#: kernel launches since the last ``reset_launches()``, by kernel name
LAUNCHES = {"spmm_balanced": 0, "spmm_epilogue": 0}

#: shared memory one thread block may use on an H100 (bytes)
MAX_SMEM = 227 * 1024

_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class DeviceSteps(NamedTuple):
    """A schedule's arrays as the kernels read them, on one device."""

    val: torch.Tensor  # [n_steps, K] f32
    lrow: torch.Tensor  # [n_steps, K] int32
    lcol: torch.Tensor  # [n_steps, K] int32
    win: torch.Tensor  # [n_steps] int32
    cblk: torch.Tensor  # [n_steps] int32
    row_map: torch.Tensor  # [n_windows * R] int32, -1 on dead slots
    win_ptr: torch.Tensor  # [n_windows + 1] int32: steps of window w
    epi_ptr: torch.Tensor  # [m + 1] int32: live slots of output row i
    epi_slot: torch.Tensor  # [n_live] int32, ascending within each row
    shape: Tuple[int, int]
    nnz_per_step: int
    rows_per_window: int
    cols_per_block: int

    @property
    def n_windows(self) -> int:
        return self.win_ptr.shape[0] - 1

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in self[:9])


def kernel_plan(sched: Schedule) -> dict:
    """Host arrays the kernels need beyond the schedule's own: the step
    range of each window (``win_ptr``) and the row → live-slot CSR of the
    epilogue (``epi_ptr``/``epi_slot``). Raises if the steps of a window
    are not one run in window order — the contract that lets one block own
    a window."""
    win = sched.win_id.astype(np.int64)
    if win.size > 1 and np.any(win[1:] < win[:-1]):
        raise ValueError(
            "schedule steps are not grouped by window in window order: a "
            "window appears in two step runs"
        )
    counts = np.bincount(win, minlength=sched.n_windows)
    win_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    rm = sched.row_map
    live = np.flatnonzero(rm >= 0)
    order = np.argsort(rm[live], kind="stable")
    rows = np.bincount(rm[live], minlength=sched.shape[0])
    epi_ptr = np.concatenate([[0], np.cumsum(rows)]).astype(np.int32)
    return {
        "win_ptr": win_ptr,
        "epi_ptr": epi_ptr,
        "epi_slot": live[order].astype(np.int32),
    }


def host_steps(sched: Schedule) -> dict:
    """Every array of ``DeviceSteps`` on the host, step-major."""
    n_steps, k = sched.n_steps, sched.nnz_per_step
    return {
        "val": sched.val.reshape(n_steps, k),
        "lrow": sched.local_row.reshape(n_steps, k),
        "lcol": sched.local_col.reshape(n_steps, k),
        "win": sched.win_id,
        "cblk": sched.col_block,
        "row_map": sched.row_map,
        **kernel_plan(sched),
    }


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("spmm_balanced")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.awb_spmm_window.argtypes = [p] * 6 + [i] * 5 + [p] + [i] * 3 + [p, p]
    lib.awb_spmm_window.restype = i
    lib.awb_spmm_epilogue.argtypes = [p, p, p, p, i, i, p, i, p]
    lib.awb_spmm_epilogue.restype = i
    return lib


def _check_cuda(steps: DeviceSteps, x: torch.Tensor, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what} is on {x.device}; the kernel runs on CUDA")
    if steps.val.device != x.device:
        raise ValueError(
            f"{what} is on {x.device} but the schedule is on {steps.val.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


# ---------------------------------------------------------------------------
# The window kernel
# ---------------------------------------------------------------------------


def spmm_window(steps: DeviceSteps, b: torch.Tensor, *, ktile: int = 128):
    """Permuted window output ``[n_windows * R, kdim]`` in f32. On CUDA only
    the live slots (``row_map >= 0``) are written; dead slots hold
    whatever the allocation held."""
    if b.device.type == "cpu":
        return spmm_window_plain(steps, b)
    _check_cuda(steps, b, "B")
    n = steps.shape[1]
    if b.dim() != 2 or b.shape[0] != n:
        raise ValueError(f"B has shape {tuple(b.shape)}; the schedule needs [{n}, k]")
    if b.dtype not in _DTYPES:
        raise ValueError(f"B is {b.dtype}; the kernel takes float32 or bfloat16")
    kdim = b.shape[1]
    r = steps.rows_per_window
    kt = max(1, min(ktile, kdim, 1024))
    if r * kt * 4 > MAX_SMEM:
        raise ValueError(
            f"rows_per_window={r} x ktile={kt} needs {r * kt * 4} bytes of "
            f"shared memory; a block has {MAX_SMEM}"
        )
    out = torch.empty((steps.n_windows * r, kdim), dtype=torch.float32,
                      device=b.device)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        LAUNCHES["spmm_balanced"] += 1
        err = _lib().awb_spmm_window(
            steps.val.data_ptr(), steps.lrow.data_ptr(), steps.lcol.data_ptr(),
            steps.cblk.data_ptr(), steps.win_ptr.data_ptr(),
            steps.row_map.data_ptr(), steps.n_windows, steps.nnz_per_step, r,
            steps.cols_per_block, n, b.data_ptr(), int(b.dtype == torch.bfloat16),
            kdim, kt, out.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"awb_spmm_window launch failed: cudaError {err}")
    return out


def spmm_window_plain(steps: DeviceSteps, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the window kernel: gather, multiply and
    ``index_add_`` into the permuted output, in f32, over chunks of steps
    so the ``[slots, kdim]`` intermediate stays bounded. Dead slots are 0."""
    n = steps.shape[1]
    k, r, cb = steps.nnz_per_step, steps.rows_per_window, steps.cols_per_block
    kdim = b.shape[1]
    out = torch.zeros((steps.n_windows * r, kdim), dtype=torch.float32,
                      device=b.device)
    n_steps = steps.win.shape[0]
    chunk = max(1, GATHER_ELEMS // max(1, k * kdim))
    for lo in range(0, n_steps, chunk):
        sl = slice(lo, lo + chunk)
        gcol = steps.cblk[sl].long()[:, None] * cb + steps.lcol[sl].long()
        gcol = torch.clamp(gcol, max=n - 1).reshape(-1)
        slot = (steps.win[sl].long()[:, None] * r + steps.lrow[sl].long())
        g = b[gcol].float() * steps.val[sl].reshape(-1)[:, None]
        out.index_add_(0, slot.reshape(-1), g)
    return out


# ---------------------------------------------------------------------------
# The epilogue kernel
# ---------------------------------------------------------------------------


def spmm_epilogue(steps: DeviceSteps, out_perm: torch.Tensor, dtype,
                  row_unperm: torch.Tensor | None = None) -> torch.Tensor:
    """Matrix rows ``[m, kdim]`` in ``dtype`` from the permuted output: row
    ``i`` sums the live slots of row ``row_unperm[i]`` (or ``i``)."""
    if out_perm.device.type == "cpu":
        return spmm_epilogue_plain(steps, out_perm, dtype, row_unperm)
    _check_cuda(steps, out_perm, "the permuted output")
    m = steps.shape[0]
    if out_perm.dtype != torch.float32 or out_perm.dim() != 2 or (
        out_perm.shape[0] != steps.n_windows * steps.rows_per_window
    ):
        raise ValueError(
            f"permuted output is {out_perm.dtype} {tuple(out_perm.shape)}; "
            f"the epilogue needs float32 [{steps.n_windows * steps.rows_per_window}, k]"
        )
    if dtype not in _DTYPES:
        raise ValueError(f"output dtype {dtype}; the kernel writes float32 or bfloat16")
    unperm_ptr = None
    if row_unperm is not None:
        _check_cuda(steps, row_unperm, "row_unperm")
        if row_unperm.dtype != torch.int32 or row_unperm.shape != (m,):
            raise ValueError(f"row_unperm must be int32 [{m}]")
        unperm_ptr = row_unperm.data_ptr()
    kdim = out_perm.shape[1]
    out = torch.empty((m, kdim), dtype=dtype, device=out_perm.device)
    with torch.cuda.device(out_perm.device):
        stream = torch.cuda.current_stream().cuda_stream
        LAUNCHES["spmm_epilogue"] += 1
        err = _lib().awb_spmm_epilogue(
            out_perm.data_ptr(), steps.epi_ptr.data_ptr(),
            steps.epi_slot.data_ptr(), unperm_ptr, m, kdim, out.data_ptr(),
            int(dtype == torch.bfloat16), stream,
        )
    if err:
        raise RuntimeError(f"awb_spmm_epilogue launch failed: cudaError {err}")
    return out


def spmm_epilogue_plain(steps: DeviceSteps, out_perm: torch.Tensor, dtype,
                        row_unperm: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the epilogue: ``index_add_`` of the live slots into
    their rows in f32, then the un-permutation and the cast."""
    rm = steps.row_map.long()
    live = rm >= 0
    out = torch.zeros((steps.shape[0], out_perm.shape[1]), dtype=torch.float32,
                      device=out_perm.device)
    out.index_add_(0, rm[live], out_perm[live])
    if row_unperm is not None:
        out = out[row_unperm.long()]
    return out.to(dtype)


# ---------------------------------------------------------------------------
# C = A @ B
# ---------------------------------------------------------------------------


def _steps_for(sched_or_steps, device) -> DeviceSteps:
    if isinstance(sched_or_steps, Schedule):
        from repro_torch.core.executor import device_step_arrays

        return device_step_arrays(sched_or_steps, device)
    return sched_or_steps


def spmm_balanced(sched_or_steps, b: torch.Tensor, *, ktile: int = 128,
                  row_unperm: torch.Tensor | None = None) -> torch.Tensor:
    """C = A @ B through the converged schedule (a ``Schedule``, uploaded
    once per device and memoized, or its ``DeviceSteps``), in ``b``'s
    dtype with f32 accumulation."""
    steps = _steps_for(sched_or_steps, b.device)
    out_perm = spmm_window(steps, b, ktile=ktile)
    return spmm_epilogue(steps, out_perm, b.dtype, row_unperm)


def spmm_balanced_plain(sched_or_steps, b: torch.Tensor, *,
                        row_unperm: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``spmm_balanced`` on any device."""
    steps = _steps_for(sched_or_steps, b.device)
    out_perm = spmm_window_plain(steps, b)
    return spmm_epilogue_plain(steps, out_perm, b.dtype, row_unperm)
