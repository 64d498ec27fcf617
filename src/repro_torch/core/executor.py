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

The executor serves inference: its methods record no autograd graph.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

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


# Device copies of schedule arrays in the kernels' layout, shared between
# ScheduleExecutor and the kernel wrapper so one schedule is uploaded once
# no matter who consumes it. Keyed on (schedule identity, device), bounded
# LRU.
_DEVICE_STEPS: "OrderedDict[tuple, tuple]" = OrderedDict()
_DEVICE_STEPS_CAP = 32


def _placed(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload host array ``x`` to ``device``."""
    FAULTS.check("upload", device=device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def device_step_arrays(sched: Schedule, device=None) -> spmm_cuda.DeviceSteps:
    """The schedule's ``spmm_cuda.DeviceSteps`` on ``device`` (default: the
    card) — step-major ``val``/``lrow``/``lcol``, per-step ``win``/``cblk``,
    ``row_map`` and the kernels' window and epilogue index arrays — uploaded
    once per (schedule instance, device) and memoized (bounded LRU)."""
    device = resolve_device(device)
    key = (id(sched), str(device))
    hit = _DEVICE_STEPS.get(key)
    if hit is not None and hit[0] is sched:
        _DEVICE_STEPS.move_to_end(key)
        return hit[1]
    arrs = {k: _placed(v, device) for k, v in spmm_cuda.host_steps(sched).items()}
    steps = spmm_cuda.DeviceSteps(
        **arrs,
        shape=sched.shape,
        nnz_per_step=sched.nnz_per_step,
        rows_per_window=sched.rows_per_window,
        cols_per_block=sched.cols_per_block,
    )
    _DEVICE_STEPS[key] = (sched, steps)
    if len(_DEVICE_STEPS) > _DEVICE_STEPS_CAP:
        _DEVICE_STEPS.popitem(last=False)
    return steps


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


class ScheduleExecutor:
    """Device-resident executor of one converged AWB schedule.

    Construction uploads the schedule to ``device`` (default: the card)
    once; ``device_bytes`` reports the resident footprint.

    ``row_unperm`` supports locality-reordered schedules (core.reorder):
    when ``sched`` was built on a row-permuted graph, pass the inverse
    permutation (``inv[old_row] = new_row``) and every output comes back in
    **original** row order. On CUDA the epilogue kernel applies it in the
    same pass.

    ``bf16_accumulate=True`` runs the CPU routing bodies' multiplies and
    accumulations in bfloat16; the CUDA kernel accumulates in f32 and
    raises ``NotImplementedError`` for it.
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
        if bf16_accumulate and self.device.type == "cuda":
            raise NotImplementedError(
                "bf16_accumulate is not implemented in the CUDA kernel, "
                "which accumulates in float32"
            )
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
        if self.device.type == "cuda":
            self._steps = device_step_arrays(sched, self.device)
            self.device_bytes = self._steps.nbytes
            self._spmm_impl = self._kernel_impl
        elif self.routing == GATHER:
            gcol, tgt, val = _gather_slots(sched)
            # pad the flat slot stream to a whole number of chunks so the
            # gather bounds its [chunk, kdim] intermediate
            s_total = gcol.shape[0]
            self._slot_chunk = int(min(slot_chunk, max(1, s_total)))
            pad = (-s_total) % self._slot_chunk
            self._n_chunks = (s_total + pad) // self._slot_chunk

            def _chunked(x, fill):
                x = np.concatenate([x, np.full(pad, fill, x.dtype)])
                return _placed(x.reshape(self._n_chunks, self._slot_chunk),
                               self.device)

            self._gcol = _chunked(gcol, 0)
            self._tgt = _chunked(tgt, 0)
            self._val = _chunked(val, 0.0)
            self.device_bytes = int(
                self._gcol.nbytes + self._tgt.nbytes + self._val.nbytes
            )
            self._spmm_impl = self._gather_impl
        else:
            self._steps = device_step_arrays(sched, self.device)
            self.device_bytes = self._steps.nbytes
            self._spmm_impl = self._onehot_impl
        if self._unperm is not None:
            self.device_bytes += int(self._unperm.nbytes)

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

    def _kernel_impl(self, b: torch.Tensor) -> torch.Tensor:
        """The hand-written kernels: window accumulation, then the epilogue
        (with the row un-permutation folded in)."""
        return spmm_cuda.spmm_balanced(
            self._steps, b.contiguous(), ktile=self.ktile, row_unperm=self._unperm
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
        s = self._steps
        ar_cb = torch.arange(cb, device=dev)
        ar_r = torch.arange(r, device=dev)
        out_perm = torch.zeros((s.n_windows, r, kdim), dtype=acc, device=dev)
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
