"""Persistent on-disk store of converged tuning artifacts.

The paper's engine "after converging, reuses the ideal configuration"; this
module makes that reuse survive process restarts. One entry holds a
``TunedConfig`` plus the winning schedule's prebuilt arrays, so a serving
restart warm-starts with **zero measured sweeps and zero schedule rebuilds**
— deserialize, upload, serve.

Layout
------
One ``.npz`` file per entry under ``<root>/v<version>/<key>.npz`` where
``root`` is, in priority order: the ``root`` argument,
``$REPRO_TORCH_TUNING_STORE``, ``~/.cache/repro-awb-gcn/tuning-torch``. The
port keeps its own root, apart from the JAX package's; the layout, the key
anatomy and the entry format are the same, so an entry written by either
package loads in the other given its root and key. Since v2, an entry whose config carries a
non-``"none"`` ``reorder`` axis also stores the winning **row permutation**
(``row_perm``), so serving re-applies the locality remapping at admission
with zero recompute. The key is a blake2b hash of

    (graph fingerprint, probe width kdim, device kind, mesh descriptor,
     store version, schedule format version, schedule builder version,
     schedule revision)

— a config tuned on one device kind or mesh never masquerades as another's,
and format *or builder* bumps miss cleanly instead of deserializing stale
bytes: entries persisted before a repair-logic change would deserialize
into geometry the new builder no longer produces, so the builder version
is both folded into the key (old entries become unreachable) and stamped
into the payload (entries written by other code lineages are dropped to a
re-tune at load, never returned). ``revision`` distinguishes streaming
repair generations of one graph (DESIGN.md §11); revision 0 is the cold
build.

Durability
----------
Writes are atomic: the entry is serialized to a same-directory temp file and
``os.replace``d into place, so a crashed writer never leaves a torn entry.
Reads treat *any* malformed entry (truncated, garbage, inconsistent
geometry) as a miss: ``load`` returns ``None`` and unlinks the corpse, and
the caller re-tunes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

import torch

from repro_torch.core.schedule import (
    SCHEDULE_BUILDER_VERSION,
    SCHEDULE_FORMAT_VERSION,
    Schedule,
    schedule_from_arrays,
    schedule_to_arrays,
)
from repro_torch.device import resolve_device
from repro_torch.tuning.space import TunedConfig

#: bump when the entry layout (not the schedule format) changes.
#: v2: the reorder axis — entries carry the winning row permutation.
STORE_VERSION = 2

ENV_ROOT = "REPRO_TORCH_TUNING_STORE"


def default_root() -> Path:
    env = os.environ.get(ENV_ROOT)
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro-awb-gcn" / "tuning-torch"


def device_kind(device=None) -> str:
    """Identity of the device the measurements ran on (default: the card)
    — measured wall-clock on one device kind says nothing about another:
    ``"gpu:<torch.cuda.get_device_name>"`` on a card, ``"cpu:cpu"`` on the
    host (the JAX package's name for its CPU device, so a host sweep keys
    alike in both packages)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return f"gpu:{torch.cuda.get_device_name(dev)}"
    return f"{dev.type}:{dev.type}"


def device_count(device=None, mesh=None) -> int:
    """Devices a sweep may span: the positions of ``mesh`` (a list of
    devices) when one is given, else the cards of ``device``'s kind
    (``torch.cuda.device_count()``), or 1 on the host."""
    if mesh is not None:
        return len(mesh)
    if resolve_device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def mesh_descriptor(max_devices: Optional[int] = None, device=None,
                    mesh=None) -> str:
    """The mesh half of the store key: how many devices the sweep was
    allowed to span. ``max_devices=1`` pins the single-device sweep (what
    the serving engine uses); ``None`` means every device the sweep may
    span (``device_count``)."""
    n_avail = device_count(device, mesh)
    n = n_avail if max_devices is None else min(max_devices, n_avail)
    return f"{max(1, n)}dev"


class TuningStore:
    """Filesystem-backed map: store key → (TunedConfig, Schedule, perm)."""

    def __init__(self, root=None):
        self.root = Path(root) if root is not None else default_root()
        self.dir = self.root / f"v{STORE_VERSION}"

    # ---- keys --------------------------------------------------------------

    def key(
        self,
        fingerprint: str,
        kdim: int,
        *,
        device: Optional[str] = None,
        mesh: Optional[str] = None,
        revision: int = 0,
    ) -> str:
        """Entry key for (graph fingerprint, probe width) on this device/
        mesh at the current code version. ``revision`` is the streaming
        repair generation (0 = cold build): repaired schedules of one
        fingerprint persist side by side without clobbering the original."""
        ident = json.dumps(
            [
                fingerprint,
                int(kdim),
                device or device_kind(),
                mesh or mesh_descriptor(),
                STORE_VERSION,
                SCHEDULE_FORMAT_VERSION,
                SCHEDULE_BUILDER_VERSION,
                int(revision),
            ]
        )
        return hashlib.blake2b(ident.encode(), digest_size=16).hexdigest()

    def path(self, key: str) -> Path:
        return self.dir / f"{key}.npz"

    # ---- IO ----------------------------------------------------------------

    def save(
        self,
        key: str,
        cfg: TunedConfig,
        sched: Schedule,
        perm: Optional[np.ndarray] = None,
    ) -> Path:
        """Atomically persist one converged configuration + its schedule.

        ``perm`` is the locality row permutation the schedule was built
        under (``perm[new_row] = old_row``); required exactly when
        ``cfg.reorder != "none"`` — an entry claiming a reorder with no
        permutation (or vice versa) cannot be applied at admission."""
        reorder = getattr(cfg, "reorder", "none")
        if (perm is not None) != (reorder != "none"):
            raise ValueError(
                f"cfg.reorder={reorder!r} but perm is "
                f"{'present' if perm is not None else 'missing'}"
            )
        payload = schedule_to_arrays(sched)
        payload["config_json"] = np.asarray(json.dumps(dataclasses.asdict(cfg)))
        payload["builder_version"] = np.asarray(SCHEDULE_BUILDER_VERSION, np.int64)
        if perm is not None:
            payload["row_perm"] = np.asarray(perm, np.int32)
        self.dir.mkdir(parents=True, exist_ok=True)
        dst = self.path(key)
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **payload)
            os.replace(tmp, dst)  # atomic on POSIX: never a torn entry
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return dst

    def load(
        self, key: str
    ) -> Optional[Tuple[TunedConfig, Schedule, Optional[np.ndarray]]]:
        """The entry for ``key`` as ``(cfg, sched, perm)``, or None.
        ``perm`` is the persisted row permutation (present exactly when
        ``cfg.reorder != "none"``; validated as a true permutation of the
        schedule's row count — a truncated or bit-rotted permutation would
        silently scramble output rows, so it is checked *here*, not at
        execution). A *malformed* entry (garbage bytes, truncated arrays,
        inconsistent geometry, unknown config fields, invalid permutation)
        is dropped and reported as a miss — the caller re-tunes instead of
        crashing. A transient I/O failure (EACCES, a flaky network mount)
        is also a miss but the entry is **kept**: healthy bytes must not be
        deleted for a read hiccup."""
        from repro_torch.core.reorder import invert_permutation

        path = self.path(key)
        if not path.exists():
            return None
        try:
            with np.load(path, allow_pickle=False) as z:
                # an entry written by a different schedule-builder lineage
                # (or one predating the stamp) deserializes into geometry
                # the current builder no longer produces — drop to re-tune
                bv = int(z["builder_version"]) if "builder_version" in z else -1
                if bv != SCHEDULE_BUILDER_VERSION:
                    raise ValueError(
                        f"builder version {bv} != {SCHEDULE_BUILDER_VERSION}"
                    )
                cfg_d = json.loads(str(z["config_json"]))
                cfg = TunedConfig(**cfg_d)
                sched = schedule_from_arrays(z)
                perm = z["row_perm"] if "row_perm" in z else None
                if (perm is not None) != (cfg.reorder != "none"):
                    raise ValueError(
                        f"reorder={cfg.reorder!r} but row_perm is "
                        f"{'present' if perm is not None else 'missing'}"
                    )
                if perm is not None:
                    if perm.shape[0] != sched.shape[0]:
                        raise ValueError(
                            f"row_perm has {perm.shape[0]} entries for "
                            f"{sched.shape[0]} rows"
                        )
                    invert_permutation(perm)  # raises unless a permutation
        except OSError as e:
            warnings.warn(
                f"tuning store: unreadable entry {path.name} "
                f"(kept): {type(e).__name__}: {e}"
            )
            return None
        except Exception as e:  # malformed entry → drop + re-tune
            warnings.warn(
                f"tuning store: dropping corrupted entry "
                f"{path.name}: {type(e).__name__}: {e}"
            )
            try:
                path.unlink()
            except OSError:
                pass
            return None
        return cfg, sched, perm

    def invalidate(self, key: str) -> None:
        try:
            self.path(key).unlink()
        except OSError:
            pass

    def entries(self) -> list:
        """Keys currently on disk (current version only)."""
        if not self.dir.is_dir():
            return []
        return sorted(p.stem for p in self.dir.glob("*.npz"))

    def nbytes(self) -> int:
        if not self.dir.is_dir():
            return 0
        return sum(p.stat().st_size for p in self.dir.glob("*.npz"))
