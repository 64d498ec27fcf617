"""Roofline accounting in H100 terms — the counterpart of
``repro.roofline.analysis``.

    compute term    = FLOPs per device / peak FLOP/s
    memory term     = bytes per device / HBM rate
    collective term = wire bytes per device / link rate

The port has no compiled HLO to parse. Its dry-run (``launch.dryrun``)
counts one position's program on the meta device: FLOPs with
``torch.utils.flop_counter.FlopCounterMode``, bytes and the HBM model from
a ``TorchDispatchMode`` log of the ops (``hbm_bytes_from_ops``), and the
collectives from what the sharded step gathers and sums
(``sharding.spmd.program_collectives``) as records for ``collective_bytes``.

Wire-byte model per collective (ring algorithms, per participant), the
JAX package's:
    all-reduce       2·(n-1)/n · bytes(out)
    all-gather         (n-1)/n · bytes(out)
    reduce-scatter     (n-1)   · bytes(out)      (operand = n·out)
    all-to-all         (n-1)/n · bytes(out)
    collective-permute            bytes(out)
The JAX package halves XLA:CPU's "promoted" bf16 all-reduces; the port's
records carry their own dtype's bytes, so nothing is halved.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable


@dataclasses.dataclass(frozen=True)
class _HW:
    """One NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor Core GPU data sheet)."""

    peak_flops_bf16: float = 989e12  # FLOP/s, dense bf16 tensor cores
    hbm_bw: float = 3.35e12          # B/s, HBM3
    link_bw: float = 450e9           # B/s per direction, NVLink 4 (900 GB/s both)
    hbm_bytes: float = 80e9


HW = _HW()

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def wire_bytes(kind: str, nbytes: float, n: int) -> float:
    """Per-participant wire bytes of one collective whose output is
    ``nbytes`` over ``n`` participants (ring model above)."""
    n = max(n, 2)
    if kind == "all-reduce":
        return 2 * (n - 1) / n * nbytes
    if kind in ("all-gather", "all-to-all"):
        return (n - 1) / n * nbytes
    if kind == "reduce-scatter":
        return (n - 1) * nbytes
    if kind == "collective-permute":
        return nbytes
    raise ValueError(f"unknown collective {kind!r}; expected one of {COLLECTIVES}")


def collective_bytes(records: Iterable[dict]) -> Dict[str, float]:
    """Per-device wire bytes by collective kind, plus raw output bytes and
    counts, from records ``{"kind", "bytes", "n"}``: the keys of the JAX
    package's ``collective_bytes_from_hlo``."""
    out: Dict[str, float] = {}
    wire_total = 0.0
    for rec in records:
        kind, nbytes = rec["kind"], rec["bytes"]
        wire = wire_bytes(kind, nbytes, rec["n"])
        out[f"{kind}_bytes"] = out.get(f"{kind}_bytes", 0.0) + nbytes
        out[f"{kind}_wire"] = out.get(f"{kind}_wire", 0.0) + wire
        out[f"{kind}_count"] = out.get(f"{kind}_count", 0) + 1
        wire_total += wire
    out["wire_bytes_total"] = wire_total
    return out


#: aten ops (overload packets, in-place variants without their "_") whose
#: operands and outputs must cross HBM: matrix products, and gathers,
#: scatters, indexing and slice updates (``copy_`` into a view is a slice
#: update); fusable elementwise ops are left out
_DOT_OPS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "dot", "convolution"}
_INDEX_OPS = {"gather", "scatter", "scatter_add", "scatter_reduce", "index", "index_put",
              "index_add", "index_copy", "index_select", "embedding", "slice_scatter",
              "select_scatter", "take_along_dim", "copy"}


#: the port's fused operators, which read each input and write each
#: output once (``kernels.flash_attention_cuda.flash_attention_op``)
_FUSED_OPS = {"flash_attention"}


def counts_in_hbm(op: str) -> bool:
    """Whether the HBM model counts op ``op`` (its overload packet's
    name)."""
    base = op.rstrip("_") if not op.startswith("_") else op
    return base in _DOT_OPS or base in _INDEX_OPS or base in _FUSED_OPS


def hbm_bytes_from_ops(op_log: Iterable[dict], param_bytes: float = 0.0) -> float:
    """HBM-traffic model (memory term v2), the port of the JAX package's
    ``tpu_hbm_bytes_from_hlo``: the traffic that must cross HBM whatever
    the fusion — the parameters (``param_bytes``), every matrix product's
    operands and output, every gather/scatter/index/slice-update's inputs
    and output, and the flash kernel's q, k, v and output. ``op_log``
    holds ``{"op", "in_bytes", "out_bytes"}`` per op
    (``launch.dryrun.OpLog``). A lower bound, as raw bytes is an upper one;
    the dry-run reports both."""
    total = float(param_bytes)
    for rec in op_log:
        if counts_in_hbm(rec["op"]):
            total += rec["in_bytes"] + rec["out_bytes"]
    return total


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   wire_bytes_per_dev: float, hw: _HW = HW) -> dict:
    compute_s = flops_per_dev / hw.peak_flops_bf16
    memory_s = bytes_per_dev / hw.hbm_bw
    collective_s = wire_bytes_per_dev / hw.link_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    bound = max(compute_s, memory_s, collective_s)
    terms.update({
        "dominant": dom.replace("_s", ""),
        "bound_s": bound,
        # fraction of peak the dominant-term-bound execution achieves
        "compute_roofline_fraction": compute_s / bound if bound else 0.0,
    })
    return terms


def model_flops(n_params: int, n_active_params: int, tokens: int,
                kind: str) -> float:
    """6·N·D (train) / 2·N·D (forward) with MoE active params."""
    n = n_active_params
    return (6.0 if kind == "train" else 2.0) * n * tokens
