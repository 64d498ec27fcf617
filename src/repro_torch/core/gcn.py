"""GCN model (Kipf & Welling) on the AWB SpMM engine, in PyTorch.

The counterpart of ``repro.core.gcn``: ``Z = Ã · ReLU( Ã · X · W1 ) · W2``
with the paper's A×(X×W) order on every layer. The sparse A·(XW) product
runs through a ``ScheduleExecutor`` (the converged AWB configuration, the
hand-written kernel on the card); X·W is a dense ``torch.matmul``, as the
JAX package leaves it to XLA.

Parameters are a dict ``{"w0": [f, h], "w1": [h, c], ...}`` of tensors, the
JAX package's layout, so ``params_from_jax`` takes its weights as they are.

Training differentiates ``loss_fn`` with an ``spmm_fn`` that autograd can go
through: the plain COO product (the default), ``make_schedule_spmm``, or
``spmm_cuda.make_spmm_fn`` (the kernels, with Aᵀ's schedule for the
backward). The executor serves inference only and records no graph.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core import csc as fmt
from repro_torch.core import spmm
from repro_torch.core.schedule import Schedule, execute_schedule_torch
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    num_features: int
    hidden: int
    num_classes: int
    n_layers: int = 2

    @property
    def dims(self) -> list:
        return [self.num_features] + [self.hidden] * (self.n_layers - 1) + [
            self.num_classes
        ]


def init_params(cfg: GCNConfig, generator: torch.Generator, device=None) -> dict:
    """Glorot-uniform weights, as in Kipf & Welling, drawn from
    ``generator`` (a CPU generator) and placed on ``device``."""
    dev = resolve_device(device)
    dims = cfg.dims
    params = {}
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        lim = float(np.sqrt(6.0 / (din + dout)))
        w = torch.rand((din, dout), generator=generator) * (2 * lim) - lim
        params[f"w{i}"] = w.to(dev)
    return params


def params_from_jax(np_params: dict, device=None) -> dict:
    """The JAX package's ``{"w0": ..., "w1": ...}`` weights, given as numpy
    arrays (``jax.tree.map(np.asarray, params)``), as float32 tensors on
    ``device``."""
    dev = resolve_device(device)
    return {
        name: torch.tensor(np.asarray(w, np.float32), device=dev)
        for name, w in np_params.items()
    }


def forward(params: dict, a: fmt.COO, x: torch.Tensor,
            spmm_fn: Optional[Callable] = None) -> torch.Tensor:
    """Logits. ``spmm_fn(b) -> A @ b`` defaults to the COO reference;
    pass a schedule- or kernel-backed callable to run the AWB engine."""
    if spmm_fn is None:
        spmm_fn = functools.partial(spmm.spmm_coo, a)
    h = x
    n_layers = len(params)
    for i in range(n_layers):
        h = spmm_fn(spmm.spmm_dense(h, params[f"w{i}"]))  # A × (X × W)
        if i < n_layers - 1:
            h = torch.relu(h)
    return h


def make_schedule_spmm(sched: Schedule) -> Callable:
    """``spmm_fn`` over the plain tensor executor of ``sched``, which
    autograd differentiates (``spmm_cuda.make_spmm_fn`` is the kernels'
    differentiable counterpart)."""
    return functools.partial(execute_schedule_torch, sched)


def forward_awb(params: dict, a: fmt.COO, x: torch.Tensor,
                sched: Optional[Schedule] = None, executor=None,
                device=None, n_devices: Optional[int] = None,
                mesh=None) -> torch.Tensor:
    """Forward pass through the converged AWB configuration on a
    ``ScheduleExecutor`` cached by graph fingerprint (device-resident
    schedule, uploaded once). Pass ``sched`` to pin a caller-built
    schedule, or ``executor`` to bring your own. ``n_devices`` (the first
    CUDA devices) or ``mesh`` (a list of devices) runs the layers' SpMMs
    on the sharded executor instead, cached by (graph fingerprint, mesh)."""
    from repro_torch.tuning import registry as _reg

    place = (dict(device=device) if n_devices is None and mesh is None
             else dict(n_devices=n_devices, mesh=mesh))
    if executor is None:
        if sched is None:
            executor = _reg.get_executor(a, **place)
        else:
            executor = _reg.executor_for_schedule(sched, **place)
    return executor.forward(params, x)


def loss_fn(params: dict, a: fmt.COO, x: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None,
            spmm_fn: Optional[Callable] = None) -> torch.Tensor:
    logits = forward(params, a, x, spmm_fn)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.take_along_dim(logp, labels.long()[:, None], dim=-1)[:, 0]
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def accuracy(params: dict, a: fmt.COO, x: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    return (forward(params, a, x).argmax(-1) == labels).float().mean()


class GCN(nn.Module):
    """The GCN as a module: weights ``w0 … w{L-1}`` as parameters, and every
    layer's A·(X·W) on ``executor``. ``forward`` takes one request
    ``[n, f]`` or a batch ``[B, n, f]`` (one SpMM per layer for the whole
    batch)."""

    def __init__(self, cfg: GCNConfig, executor, params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.executor = executor
        if params is None:
            params = init_params(cfg, generator or torch.Generator(),
                                 device=executor.device)
        for name, w in params.items():
            self.register_parameter(name, nn.Parameter(executor.commit(w)))

    @property
    def params(self) -> dict:
        return {f"w{i}": getattr(self, f"w{i}") for i in range(self.cfg.n_layers)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            return self.executor.forward_batch(self.params, x)
        return self.executor.forward(self.params, x)
