"""Mixture-of-Experts FFN with AWB-balanced dispatch.

The counterpart of ``repro.models.moe``. Top-k routing with capacity-bounded
sort-based dispatch (stable argsort + ``searchsorted`` arrival ranks, then a
scatter-add into per-slot buffers), expert compute as stacked batched
products, and a weighted gather-combine.

AWB integration (DESIGN.md §5): router histograms are power-law — a few
"evil" experts absorb most tokens. ``core.moe_balance`` turns a profiled
load into an ``ExpertPlacement`` with hot-expert *replicas*; dispatch takes
it as ``PlacementTables`` and routes arrival i of expert e to replica
``i % r_e``, chunking an evil expert across slots as evil-row remapping
chunks a row across PEs. The combine step's weighted sum is the adder tree.
With ``placement=None`` dispatch is the static layout (the paper's
baseline).

``route`` holds the routing decisions (gate weights, expert ids, slot,
arrival rank, capacity ``keep`` mask, aux loss); ``moe_forward`` calls it,
then ``moe_apply`` dispatches, computes and combines. A ``RoutePrior``
routes one part of a larger batch as the whole batch routes it (a data
position's rows on a mesh, ``sharding.spmd``): ranks continue after the
earlier parts' choices, capacity is the whole batch's. The JAX package's sharding hints
are no-ops without a mesh and have no counterpart here. Where the two
packages could silently part:

* ranks are exact integers (stable argsort, ``searchsorted(right=False)``);
* capacity is host arithmetic in the reference's operand order;
* the dispatch scatter *adds* (``index_put_(accumulate=True)``): a dropped
  token adds its zero row at position ``cap − 1`` instead of overwriting
  the token kept there;
* slot→expert indices follow JAX's gather: negative ones wrap, ones past
  the last expert clamp to it (``identity_placement`` with more slots than
  experts reads past the end);
* under the static layout the expert weights are used as they are, not
  gathered per slot (the same values, without a copy of every expert's
  weights on each call).

Each phase runs under a ``torch.profiler`` range (``moe.router``,
``moe.dispatch``, ``moe.experts``, ``moe.combine``) while a profiler is
recording; otherwise the ranges cost one flag check.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch import tracing
from repro_torch.models import common


class MoEDims(NamedTuple):
    d_model: int
    d_ff: int          # per-expert hidden
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    activation: str = "silu"
    glu: bool = True
    n_slots: int = 0   # 0 => n_experts (no replication headroom)
    n_groups: int = 1  # dispatch groups: ranks, capacity and buffers per group


class PlacementTables(NamedTuple):
    """AWB placement as device tables: slot_of[e, r] = slot hosting replica
    r of e (padded by repeating replica 0); n_replicas[e] ≥ 1; slot s holds
    expert expert_of[s] (-1 for an empty slot)."""

    slot_of: torch.Tensor     # [E, max_rep] int64
    n_replicas: torch.Tensor  # [E] int64
    expert_of: torch.Tensor   # [n_slots] int64


class Routing(NamedTuple):
    """The routing decisions of one call, per dispatch group ``G`` of
    ``Tg`` tokens, each routed to ``K`` experts (flattened ``Tg·K`` in token
    order)."""

    probs: torch.Tensor       # [G, Tg, E] f32 router probabilities
    gate_w: torch.Tensor      # [G, Tg, K] f32 top-k weights, renormalised
    expert_ids: torch.Tensor  # [G, Tg, K] int64, by falling probability
    slot: torch.Tensor        # [G, Tg·K] slot each choice is sent to
    pos: torch.Tensor         # [G, Tg·K] arrival rank within its slot
    keep: torch.Tensor        # [G, Tg·K] bool: pos < capacity
    capacity: int             # rows a slot's buffer holds per group
    aux: torch.Tensor         # () f32 load-balance loss


class RoutePrior(NamedTuple):
    """Where this call's tokens stand in a larger batch routed in flattened
    token order (the reference's ``n_groups = 1`` over the whole batch):
    the earlier tokens' choices per expert and per slot, and the batch's
    token count. Arrival ranks start after the earlier choices, the AWB
    replica follows the batch-wide rank, capacity is the batch's, and
    ``ce`` (the batch's share of choices per expert), where given, stands
    for this call's own in the aux loss, which is then this call's share
    of the batch's (E·Σ me_e·ce_e is linear in the router means me)."""

    expert_counts: torch.Tensor   # [E] int64
    slot_counts: torch.Tensor     # [n_slots] int64
    n_tokens: int
    ce: Optional[torch.Tensor] = None  # [E] f32


def identity_placement(dims: MoEDims, device=None) -> PlacementTables:
    e = dims.n_experts
    dev = resolve_device(device)
    return PlacementTables(
        slot_of=torch.arange(e, device=dev)[:, None],
        n_replicas=torch.ones(e, dtype=torch.long, device=dev),
        expert_of=torch.arange(dims.n_slots or e, device=dev),
    )


def tables_from_placement(placement, device=None) -> PlacementTables:
    """Convert a ``core.moe_balance.ExpertPlacement`` to device tables."""
    slots = np.asarray(placement.slots).reshape(-1)         # [n_slots]
    rrank = np.asarray(placement.replica_rank).reshape(-1)
    reps = np.asarray(placement.replica_count)
    e = reps.shape[0]
    max_rep = int(reps.max())
    slot_of = np.zeros((e, max_rep), np.int64)
    for s, (eid, r) in enumerate(zip(slots, rrank)):
        if eid >= 0:
            slot_of[eid, r] = s
    for eid in range(e):  # pad unused replica slots with replica 0
        slot_of[eid, reps[eid]:] = slot_of[eid, 0]
    dev = resolve_device(device)
    return PlacementTables(*(torch.from_numpy(np.asarray(a, np.int64)).to(dev)
                             for a in (slot_of, reps, slots)))


def init_moe_params(generator: Optional[torch.Generator], dims: MoEDims,
                    device=None) -> dict:
    """Random parameters drawn from ``generator`` on its device (on the meta
    device no generator is needed). Expert weights are stacked ``[E, ...]``
    and scaled by their fan-in ``** -0.5``, as ``common.dense_init``."""
    e, d, f = dims.n_experts, dims.d_model, dims.d_ff

    def stacked(shape):
        return common.dense_init(generator, (e,) + shape, scale=shape[0] ** -0.5,
                                 device=device)

    p = {
        "router": common.dense_init(generator, (d, e), device=device),
        "w_in": stacked((d, f)),
        "w_out": stacked((f, d)),
    }
    if dims.glu:
        p["w_gate"] = stacked((d, f))
    return p


def rank_within(ids: torch.Tensor) -> torch.Tensor:
    """Arrival rank of each element of ``ids`` [G, N] within its bucket
    (equal ids), per group: a stable sort, each run's start by
    ``searchsorted``, and the ranks scattered back to arrival order."""
    order = torch.argsort(ids, dim=-1, stable=True)
    sorted_ids = torch.gather(ids, -1, order)
    seg_start = torch.searchsorted(sorted_ids, sorted_ids, right=False)
    pos_sorted = torch.arange(ids.shape[-1], device=ids.device) - seg_start
    return torch.zeros_like(pos_sorted).scatter_(-1, order, pos_sorted)


def route(p: dict, dims: MoEDims, x: torch.Tensor,
          placement: Optional[PlacementTables] = None,
          capacity_override: Optional[int] = None,
          prior: Optional[RoutePrior] = None) -> Routing:
    """Routing of x [B, S, d]: softmax router in f32, top-k, renormalised
    gate weights, the aux loss (Switch: E·Σ f_e·p_e), then each choice's
    slot (replica ``rank % r_e`` of its expert) and arrival rank there,
    and which choices fit the capacity. With ``prior`` the tokens are a
    later part of a larger batch (one dispatch group)."""
    b, s, d = x.shape
    t = b * s
    e, k = dims.n_experts, dims.top_k
    n_slots = dims.n_slots or e
    g = dims.n_groups if t % max(dims.n_groups, 1) == 0 else 1
    if prior is not None and g != 1:
        raise ValueError("a RoutePrior routes one dispatch group (n_groups 1)")
    tg = t // g
    with tracing.span("moe.router"):
        xt = x.reshape(g, tg, d)
        logits = (xt @ p["router"].to(xt.dtype)).float()
        probs = torch.softmax(logits, dim=-1)                          # [G,Tg,E]
        # lax.top_k puts the lower expert first on an exact tie, as a stable
        # descending sort does; torch.topk promises no order on ties
        ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate_w, expert_ids = ranked[..., :k], order[..., :k]           # [G,Tg,K]
        gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
        me = probs.mean(dim=(0, 1))
        if prior is not None and prior.ce is not None:
            ce = prior.ce
        else:
            ce = torch.zeros(e, device=x.device).index_add_(
                0, expert_ids.reshape(-1),
                torch.full((t * k,), 1.0 / (t * k), device=x.device))
        aux = e * torch.sum(me * ce)
    with tracing.span("moe.dispatch"):
        flat_e = expert_ids.reshape(g, tg * k)                          # [G,TKg]
        pos = rank_within(flat_e)
        if placement is None:  # the static layout: slot e hosts expert e
            flat_slot = flat_e
        else:
            if prior is not None:
                pos = pos + prior.expert_counts[flat_e]
            # evil-expert chunking: replica r = arrival rank % n_replicas
            replica = pos % placement.n_replicas[flat_e]
            max_rep = placement.slot_of.shape[1]
            flat_slot = placement.slot_of[flat_e, replica.clamp(max=max_rep - 1)]
            pos = rank_within(flat_slot)  # rank within the *slot*
        if prior is not None:
            pos = pos + prior.slot_counts[flat_slot]
    n_tok = tg if prior is None else prior.n_tokens
    cap = capacity_override or max(1, int(dims.capacity_factor * n_tok * k / n_slots))
    return Routing(probs, gate_w, expert_ids, flat_slot, pos, pos < cap, cap, aux)


def _slot_weights(p: dict, dims: MoEDims, placement: Optional[PlacementTables],
                  dtype) -> tuple:
    """Each slot's expert weights (replicas share them). JAX's gather wraps
    a negative index and clamps one past the end; so does this."""
    e = dims.n_experts
    names = ("w_in", "w_out", "w_gate") if dims.glu else ("w_in", "w_out")
    if placement is None and (dims.n_slots or e) == e:
        return tuple(p[n].to(dtype) for n in names)
    expert_of = (placement.expert_of if placement is not None
                 else torch.arange(dims.n_slots, device=p["w_in"].device))
    idx = torch.where(expert_of < 0, expert_of + e, expert_of).clamp(0, e - 1)
    return tuple(p[n][idx].to(dtype) for n in names)


def moe_forward(p: dict, dims: MoEDims, x: torch.Tensor,
                placement: Optional[PlacementTables] = None,
                capacity_override: Optional[int] = None,
                prior: Optional[RoutePrior] = None) -> tuple:
    """x: [B, S, d] -> (out, aux_loss). Capacity-dropped tokens pass through
    the residual (standard Switch behaviour). ``capacity_override`` forces a
    per-slot capacity (decode uses T·K: dropless); ``prior`` routes x as a
    later part of a larger batch (``RoutePrior``)."""
    r = route(p, dims, x, placement, capacity_override, prior)
    return moe_apply(p, dims, x, r, placement, prior), r.aux


def moe_apply(p: dict, dims: MoEDims, x: torch.Tensor, r: Routing,
              placement: Optional[PlacementTables] = None,
              prior: Optional[RoutePrior] = None) -> torch.Tensor:
    """Dispatch x [B, S, d] by the routing ``r``, run the experts, combine.
    Under a ``prior`` the buffers hold only this call's choices: a slot's
    row is the choice's rank less the earlier parts' choices there, and a
    slot holds at most min(capacity, this call's choices) rows."""
    b, s, d = x.shape
    k = dims.top_k
    n_slots = dims.n_slots or dims.n_experts
    g, tgk = r.slot.shape
    tg = tgk // k
    act = common.activation_fn(dims.activation)
    with tracing.span("moe.dispatch"):
        if prior is None:
            rows, local = r.capacity, r.pos
        else:
            rows, local = min(r.capacity, tgk), r.pos - prior.slot_counts[r.slot]
        xt = x.reshape(g, tg, d)
        gi = torch.arange(g, device=x.device)[:, None].expand(g, tgk)
        pos_c = local.clamp(max=rows - 1)
        src = xt.repeat_interleave(k, dim=1) * r.keep[..., None].to(x.dtype)
        buf = torch.zeros((g, n_slots, rows, d), dtype=x.dtype, device=x.device)
        buf.index_put_((gi, r.slot, pos_c), src, accumulate=True)
    with tracing.span("moe.experts"):
        w = _slot_weights(p, dims, placement, x.dtype)
        h = torch.einsum("gscd,sdf->gscf", buf, w[0])
        if dims.glu:
            h = act(torch.einsum("gscd,sdf->gscf", buf, w[2])) * h
        else:
            h = act(h)
        out_buf = torch.einsum("gscf,sfd->gscd", h, w[1])             # [G,S,C,d]
    with tracing.span("moe.combine"):
        # the adder tree: weighted gather back to tokens
        gathered = out_buf[gi, r.slot, pos_c]                           # [G,TKg,d]
        gathered = gathered * (r.gate_w.reshape(g, tgk)[..., None].to(x.dtype)
                               * r.keep[..., None].to(x.dtype))
        out = gathered.reshape(g, tg, k, d).sum(dim=2)
    return out.reshape(b, s, d)
