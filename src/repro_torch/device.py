"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the current CUDA device. Without a CUDA device this
    raises instead of falling back to the CPU: a run that silently moved
    to the host would report host numbers as the card's. Callers that
    want the CPU (the parity tests) pass ``device="cpu"``.

    A CUDA device without an index (``"cuda"``) resolves to the current
    one, ``cuda:<current_device()>``, so every spelling of one card keys
    the caches (executors, uploads, residency) alike.
    """
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run on the "
            "host explicitly"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve_mesh(n_devices=None, mesh=None) -> list:
    """The positions of a 1-D device mesh, as a list of ``torch.device``.

    The port's counterpart of the JAX package's ``Mesh`` of
    ``jax.devices()``: ``mesh`` is a list of devices, one per position, and
    may name one device more than once (``["cpu"] * 8`` stands for the
    reference's 8 forced host devices; ``["cuda:0"] * 4`` runs four
    positions on one card). Without ``mesh``, ``n_devices`` takes the first
    ``n_devices`` CUDA devices (default: all of them) and raises beyond
    ``torch.cuda.device_count()``. ``n_devices`` beside a ``mesh`` must
    equal its length. The positions must be of one device type."""
    if mesh is None:
        n_avail = torch.cuda.device_count()
        if n_devices is None:
            n_devices = n_avail
        if not 1 <= n_devices <= n_avail:
            raise ValueError(
                f"n_devices={n_devices} but this host exposes {n_avail} CUDA "
                "device(s); pass mesh=[...] to name the positions (e.g. "
                "[\"cpu\"] * n on the host)"
            )
        return [torch.device("cuda", i) for i in range(n_devices)]
    if isinstance(mesh, (str, torch.device)):
        raise ValueError(f"mesh must be a list of devices, got {mesh!r}")
    positions = list(mesh)
    if any(isinstance(d, (list, tuple)) for d in positions):
        raise ValueError(
            "the sharded executor shards over one step axis and needs a 1-D "
            f"mesh; got a nested list {mesh!r}"
        )
    if n_devices is not None and n_devices != len(positions):
        raise ValueError(
            f"n_devices={n_devices} contradicts the given mesh of "
            f"{len(positions)} device(s); pass one or the other"
        )
    if not positions:
        raise ValueError("mesh names no device")
    positions = [resolve_device(d) for d in positions]
    if len({d.type for d in positions}) > 1:
        raise ValueError(f"mesh positions must be of one device type, got {positions}")
    return positions
