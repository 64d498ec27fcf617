"""Checkpointing with fault-tolerance semantics — the port of
``repro.training.checkpoint``, in its on-disk format.

* **Atomic**: write to ``step_N.tmp/``, fsync, rename — a crash mid-write
  never corrupts the latest checkpoint; restore picks the newest complete
  directory.
* **Keep-k** garbage collection.
* **Async**: a background writer thread drains a depth-1 queue so the train
  loop keeps stepping. The snapshot is taken on the host (numpy copies)
  before the enqueue, so the writer never touches a tensor and the loop may
  overwrite its tensors at once.
* **Format**: ``arrays.npz`` keyed by the JAX package's ``"/"``-joined
  pytree paths (``training.tree``), and ``meta.json`` with ``step``,
  ``time``, ``extra``, ``keys`` and ``dtypes``; bf16 (and fp8) stored as
  their bits (``uint16``, ``uint8``) under their dtype's name. A checkpoint
  written by either package restores in the other.
* **Placement**: ``restore(..., device=)`` puts every tensor on one device
  (the JAX package's ``shardings``); by default each goes where its
  template leaf is.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.training.tree import flatten_with_paths, map_with_path

#: dtypes numpy has no type for, stored as their bits (``uint16`` for
#: 2-byte types, ``uint8`` for 1-byte ones) under their name
_BITS = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
         "float8_e5m2": torch.float8_e5m2}
_BIT_NAMES = {t: name for name, t in _BITS.items()}


def _host(leaf) -> tuple:
    """A leaf's host snapshot for ``arrays.npz`` (a copy) and its dtype's
    name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype in _BIT_NAMES:
            wide = t.element_size() == 2
            bits = t.view(torch.int16 if wide else torch.uint8).to("cpu", copy=True)
            return bits.numpy().view(np.uint16 if wide else np.uint8), _BIT_NAMES[t.dtype]
        arr = t.to("cpu", copy=True).numpy()
        return arr, str(arr.dtype)
    arr = np.array(leaf)
    name = str(arr.dtype)
    if arr.dtype.kind == "V" or "bfloat16" in name or "float8" in name:
        arr = arr.view(np.uint8 if arr.dtype.itemsize == 1 else np.uint16)
    return arr, name


def _tensor(arr: np.ndarray, name: Optional[str]) -> torch.Tensor:
    """The tensor a stored array holds, given its dtype's name."""
    if name in _BITS:
        signed = arr.view(np.int16 if arr.dtype.itemsize == 2 else np.uint8)
        return torch.from_numpy(signed).view(_BITS[name])
    if name and str(arr.dtype) != name:
        arr = arr.view(np.dtype(name))
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3,
                 async_write: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        if async_write:
            self._thread = threading.Thread(target=self._writer, daemon=True)
            self._thread.start()

    # -- write ------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             block: bool = True) -> None:
        """Snapshot to host, then write (sync) or enqueue (async)."""
        flat = {k: _host(v) for k, v in flatten_with_paths(tree).items()}
        if self._thread is None or block:
            self._write(step, flat, extra or {})
        else:
            self._raise_if_failed()
            self._queue.put((step, flat, extra or {}))

    def _writer(self):
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                self._write(*item)
            except BaseException as e:  # surfaced on the next save() or wait()
                self._error = e
            finally:
                self._queue.task_done()

    def _raise_if_failed(self):
        if self._error:
            raise RuntimeError("async checkpoint writer failed") from self._error

    def _write(self, step: int, flat: dict, extra: dict) -> None:
        tmp = self.dir / f"step_{step:09d}.tmp"
        final = self.dir / f"step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **{k: arr for k, (arr, _) in flat.items()})
        (tmp / "meta.json").write_text(json.dumps(
            {"step": step, "time": time.time(), "extra": extra,
             "keys": sorted(flat), "dtypes": {k: n for k, (_, n) in flat.items()}}))
        # fsync the directory entry then atomically rename
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        done = sorted(p for p in self.dir.glob("step_*")
                      if not p.name.endswith(".tmp"))
        for old in done[: max(0, len(done) - self.keep)]:
            shutil.rmtree(old)

    def wait(self):
        """Block until every enqueued checkpoint is on disk (call before
        exit); raises if the writer failed."""
        if self._thread is not None:
            self._queue.join()
        self._raise_if_failed()

    def close(self):
        """``wait``, then stop the writer thread."""
        try:
            self.wait()
        finally:
            if self._thread is not None:
                self._queue.put(None)
                self._thread.join()
                self._thread = None

    # -- read -------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        done = sorted(p for p in self.dir.glob("step_*")
                      if not p.name.endswith(".tmp"))
        if not done:
            return None
        return int(done[-1].name.split("_")[1])

    def restore(self, template: Any, step: Optional[int] = None,
                device=None) -> tuple:
        """Restore into ``template``'s structure as tensors of the stored
        dtypes, on ``device`` or, by default, each on its template leaf's
        device (the CPU for a leaf that is not a tensor). Raises
        ``KeyError`` when the checkpoint lacks one of the template's
        keys."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = self.dir / f"step_{step:09d}"
        meta = json.loads((path / "meta.json").read_text())
        dtypes = meta.get("dtypes", {})
        dev = None if device is None else resolve_device(device)

        with np.load(path / "arrays.npz") as arrays:
            def leaf(key, like):
                where = dev if dev is not None else (
                    like.device if isinstance(like, torch.Tensor) else "cpu")
                return _tensor(arrays[key], dtypes.get(key)).to(where)

            tree = map_with_path(leaf, template)
        return tree, meta


def simulate_preemption_restart(manager: CheckpointManager, template,
                                device=None):
    """Test/ops helper: pretend the job died and came back — restore the
    newest complete checkpoint (ignoring any half-written .tmp dirs)."""
    return manager.restore(template, device=device)
