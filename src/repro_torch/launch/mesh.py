"""Meshes of named axes over torch devices — the counterpart of
``repro.launch.mesh``.

A mesh is a grid of *positions* with named axes (``("data", "model")`` or
``("pod", "data", "model")``). A position is a ``torch.device``, and one
device may stand for several positions: ``["cuda:0"] * 4`` runs a 2 × 2 mesh
on one card, ``["cpu"] * 8`` stands for the JAX package's 8 forced host
devices. Everything runs in one process: the sharded steps
(``launch.steps``) place each shard on its position and move tensors
between positions with ``.to()``; no ``torch.distributed`` group is formed.
``device.resolve_mesh`` is the one-axis case.

Kept as functions, as in the JAX package: the production meshes' positions
are on the meta device, so building one allocates nothing and needs no card.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence

import torch

from repro_torch.device import resolve_mesh


class Mesh:
    """Named axes over a grid of positions.

    ``shape`` maps each axis name to its size, in axis order (as
    ``jax.sharding.Mesh.shape``); ``devices`` holds the positions as a
    nested list of ``torch.device`` of that shape; ``size`` counts them."""

    def __init__(self, devices: Sequence[torch.device], shape: Sequence[int],
                 axis_names: Sequence[str]):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axes {axis_names} do not name the dims of {shape}")
        flat = [torch.device(d) for d in devices]
        if len(flat) != math.prod(shape):
            raise ValueError(f"{len(flat)} devices for a mesh of shape {shape}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self._flat = flat

    @property
    def size(self) -> int:
        return len(self._flat)

    @property
    def devices(self) -> list:
        """The positions as a nested list of the mesh's shape."""
        def nest(flat, dims):
            if len(dims) == 1:
                return list(flat)
            step = len(flat) // dims[0]
            return [nest(flat[i * step:(i + 1) * step], dims[1:]) for i in range(dims[0])]

        return nest(self._flat, list(self.shape.values()))

    def positions(self) -> list:
        """Every position's coordinates (one index per axis), row-major."""
        return list(itertools.product(*(range(n) for n in self.shape.values())))

    def device(self, pos) -> torch.device:
        """The device of the position with coordinates ``pos``."""
        flat = 0
        for i, n in zip(pos, self.shape.values()):
            flat = flat * n + i
        return self._flat[flat]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={sorted({str(d) for d in self._flat})})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 × 16 ``("data", "model")`` (one pod, 256 positions) or 2 × 16 × 16
    ``("pod", "data", "model")`` (512), every position on the meta device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh([torch.device("meta")] * math.prod(shape), shape, axes)


def make_local_mesh(model_axis: int = 1, devices=None) -> Mesh:
    """A ``("data", "model")`` mesh over ``devices`` (default: every CUDA
    card, raising without one; ``["cpu"] * 8`` on the host), ``model_axis``
    positions along ``model``."""
    positions = resolve_mesh(mesh=devices)
    if len(positions) % model_axis:
        raise ValueError(f"{len(positions)} positions do not split into a model "
                         f"axis of {model_axis}")
    return Mesh(positions, (len(positions) // model_axis, model_axis), ("data", "model"))


def dp_axes(mesh) -> tuple:
    """Data-parallel axes: ``('pod', 'data')`` on the multi-pod mesh."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
