"""The LM on a data × model mesh, in one process: what the sharded steps of
``launch.steps`` run.

Parameters, optimizer state and caches are ``partition.Sharded``: each
position holds only its block of every leaf, as ``partition``'s specs say.
A step runs the data positions in order, each on its own rows of the batch
(``batch_pspecs``), through the model's own layers (``transformer._layer``,
``_layer_prefill``, ``_layer_decode``) with ``Run.ops`` in place of their
attention and dense MLP calls:

* Attention splits by query heads and their KV heads over the model
  positions: position m projects, attends (the flash kernel on the card,
  once per position on its head slice) and applies its rows of ``wo``; the
  partial outputs are summed in position order onto the data position's
  first position. Where the heads do not divide, the attention runs whole
  there, as ``partition._fit`` falls back.
* The dense MLP splits ``w_in``/``w_gate`` by column and ``w_out`` by row
  likewise.
* Every other weight (embedding, norms, the head, cross-attention, MoE,
  RG-LRU and RWKV blocks) is gathered onto the data position's first
  position: the embedding, the head and the final norms once a data
  position, each layer's as the layer is read (``Run.at``).
* Training differentiates each data position's loss, weighted by its share
  of the rows, with respect to the weights it gathered; the gradients are
  scattered back onto the blocks, data position by data position in order,
  so two runs are bit-equal.
* With ``kv_seq_shard`` (``hints.get_flag``), decode splits each cache's
  sequence over the model positions: each attends over its slice, and the
  softmax partials (max, sum, output) are combined in position order.
* A MoE layer routes the whole batch as one device does (the reference's
  one dispatch group): the data positions route in order, each choice's
  arrival rank continuing after the choices of the positions before it
  (their per-expert and per-slot counts, all-gathered once a MoE layer),
  capacity counted from the whole batch's tokens, and the AWB replica
  taken from the batch-wide rank (``moe.RoutePrior``). Training first
  routes every data position without gradients, so that each position's
  aux loss reads the whole batch's share of choices per expert; the
  differentiated pass then routes as that pass did.

Tensors move between positions with ``.to()``; positions that name one
device share its memory and run one after another. ``Run.log`` records the
collectives position (0, 0) takes part in — all-gathers of weight blocks,
all-reduces of partial sums (in the forward, remat's recompute and the
backward), the gradients' reductions, the decode combine — which the
dry-run's wire bytes come from (``program_collectives`` walks the same
regions without running anything).
"""

from __future__ import annotations

import functools
import math
from collections.abc import Sequence
from typing import Optional

import torch

from repro_torch.launch.mesh import Mesh, dp_axes
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tr
from repro_torch.models.attention import (_project_qkv, attn_decode, attn_forward,
                                          attn_prefill)
from repro_torch.models.mlp import mlp_forward
from repro_torch.sharding import partition
from repro_torch.sharding.hints import get_flag, hints
from repro_torch.sharding.partition import Sharded
from repro_torch.training.tree import flatten_with_paths, tree_map

#: the layer kinds whose self-attention splits by heads
ATTN_KINDS = ("attn", "local", "attn_moe", "enc", "xattn")


def _elt(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def position(mesh: Mesh, d: int, m: int) -> tuple:
    """The coordinates of data position ``d`` (row-major over the data
    axes) and model position ``m``."""
    dp = [a for a in mesh.axis_names if a != "model"]
    coords = {}
    for a in reversed(dp):
        coords[a] = d % mesh.shape[a]
        d //= mesh.shape[a]
    coords["model"] = m
    return tuple(coords[a] for a in mesh.axis_names)


def data_size(mesh: Mesh) -> int:
    return math.prod(n for a, n in mesh.shape.items() if a != "model")


def first_device(mesh: Mesh) -> torch.device:
    return mesh.device(mesh.positions()[0])


def mesh_hints(mesh: Mesh, **flags):
    """``hints`` over the mesh's data axes and ``model``."""
    dp = dp_axes(mesh)
    return hints(mesh, dp[0] if len(dp) == 1 else dp, "model", **flags)


# ---------------------------------------------------------------------------
# How the step splits a layer
# ---------------------------------------------------------------------------


def attn_splits(dims, tp: int) -> bool:
    return dims.n_heads % tp == 0 and dims.n_kv_heads % tp == 0


def attn_regions(dims, tp: int, m: int) -> tuple:
    """(the regions of model position m's head slice in each attention
    weight, its ``AttnDims``, its KV heads' range)."""
    hq, hk, dh = dims.n_heads // tp, dims.n_kv_heads // tp, dims.d_head
    q = (m * hq * dh, (m + 1) * hq * dh)
    kv = (m * hk * dh, (m + 1) * hk * dh)
    regions = {"wq": (None, q), "wk": (None, kv), "wv": (None, kv), "wo": (q,),
               "bq": (q,), "bk": (kv,), "bv": (kv,), "q_norm": (), "k_norm": ()}
    return regions, dims._replace(n_heads=hq, n_kv_heads=hk), (m * hk, (m + 1) * hk)


def mlp_splits(d_ff: int, tp: int) -> bool:
    return d_ff % tp == 0


def mlp_regions(d_ff: int, tp: int, m: int) -> dict:
    f = (m * d_ff // tp, (m + 1) * d_ff // tp)
    return {"w_in": (None, f), "w_gate": (None, f), "w_out": (f,)}


def _region_shape(shape, region) -> tuple:
    region = tuple(region) + (None,) * (len(shape) - len(region))
    return tuple(n if r is None else r[1] - r[0] for n, r in zip(shape, region))


def gather_record(shape, dtype, spec, mesh, region, pos) -> Optional[dict]:
    """The collective that brings ``region`` of a tensor stored under
    ``spec`` to position ``pos``: an all-gather over the blocks covering it,
    a transfer when one other position's block covers it, else none."""
    region = tuple(region) + (None,) * (len(shape) - len(region))
    local = partition.local_shape(shape, spec, mesh)
    n, held = 1, partition.block_of(pos, spec, mesh)
    own = True
    for r, size, full, b in zip(region, local, shape, held):
        lo, hi = (0, full) if r is None else r
        first, last = lo // size, -(-hi // size)
        n *= last - first
        own &= first == b and last == b + 1
    nbytes = math.prod(_region_shape(shape, region)) * _elt(dtype)
    if n > 1:
        return {"kind": "all-gather", "bytes": nbytes, "n": n}
    if not own:
        return {"kind": "collective-permute", "bytes": nbytes, "n": 2}
    return None


def moe_counts_record(dims, n_data: int) -> dict:
    """The all-gather of every data position's per-expert and per-slot
    choice counts (int64) that a MoE layer's global routing reads."""
    return {"kind": "all-gather", "n": n_data,
            "bytes": n_data * (dims.n_experts + (dims.n_slots or dims.n_experts)) * 8}


def reduction_record(spec, mesh, nbytes: int, n: int) -> dict:
    """The reduction of ``n`` data positions' gradients of a block: a
    reduce-scatter where the spec splits the leaf over the data axes, else
    an all-reduce."""
    dp = set(a for a in mesh.axis_names if a != "model")
    split = any(e is not None and set(e if isinstance(e, tuple) else (e,)) & dp
                for e in spec)
    return {"kind": "reduce-scatter" if split else "all-reduce", "bytes": nbytes, "n": n}


# ---------------------------------------------------------------------------
# One step's run
# ---------------------------------------------------------------------------


class _LayerMoE(dict):
    """A MoE layer's gathered weights, which know their layer: the key of
    the routing state ``Run`` carries from one data position to the next."""

    def __init__(self, weights: dict, layer: int):
        super().__init__(weights)
        self.layer = layer


class _Gathered(Sequence):
    """A layer stack whose i-th layer is gathered (``Run.layer_weights``)
    when it is read."""

    def __init__(self, run, d: int, kinds: list, layers: list, whole_attn=()):
        self.run, self.d, self.kinds, self.layers = run, d, kinds, layers
        self.whole_attn = set(whole_attn)

    def __len__(self) -> int:
        return len(self.layers)

    def __getitem__(self, i):
        return self.run.layer_weights(self.kinds[i], self.layers[i], self.d,
                                      split_attn=i not in self.whole_attn, layer=i)


class Run:
    """One step over the mesh: gathers weights per (data, model) position,
    keeps what training differentiates, logs position (0, 0)'s
    collectives into ``log``."""

    def __init__(self, cfg, mesh: Mesh, params: dict, train: bool,
                 log: Optional[list] = None):
        self.cfg, self.mesh, self.params = cfg, mesh, params
        self.tp = mesh.shape["model"]
        self.train = train
        self.uses: list = []  # (Sharded, region, leaf) of the current data position
        self.reached: dict = {}  # id(Sharded) -> data positions adding into (0, 0)'s block
        self.log: list = [] if log is None else log
        # MoE routing over the whole batch (``route_globally``)
        self.moe_data = 1
        self.moe_tokens: Optional[int] = None
        self.moe_priors: dict = {}  # (d, layer) -> moe.RoutePrior
        self.moe_counts: dict = {}  # layer -> (expert, slot) counts of positions routed
        self.moe_settled = False    # every position routed: the aux reads the batch's ce

    def route_globally(self, n_data: int, n_tokens: int) -> None:
        """Route the MoE layers as one batch of ``n_tokens`` tokens over
        ``n_data`` data positions, taken in order (one position routes as
        it is)."""
        if n_data > 1:
            self.moe_data, self.moe_tokens = n_data, n_tokens

    def dev(self, d: int, m: int) -> torch.device:
        return self.mesh.device(position(self.mesh, d, m))

    def note(self, d: int, m: int, record: Optional[dict]) -> None:
        if record is not None and d == 0 and m == 0:
            self.log.append(record)

    # ---- weights -------------------------------------------------------------

    def weight(self, sh: Sharded, region, d: int, m: int) -> torch.Tensor:
        """``region`` of a parameter on position (d, m); a fresh leaf when
        training."""
        self.note(d, m, gather_record(sh.shape, sh.dtype, sh.spec, self.mesh, region,
                                      position(self.mesh, d, m)))
        t = sh.read(region, self.dev(d, m))
        if self.train:
            t = t.detach().requires_grad_(True)
            self.uses.append((sh, region, t))
        return t

    def whole(self, tree, d: int):
        return tree_map(lambda sh: self.weight(sh, (), d, 0), tree)

    def layer_weights(self, kind: str, p_sh: dict, d: int, split_attn=True,
                      layer: int = 0) -> dict:
        """The layer's weights as ``ops`` read them: a list with one dict
        per model position for a split attention or MLP, whole on (d, 0)
        otherwise (a MoE's as ``_LayerMoE`` of layer ``layer``)."""
        cfg, lw = self.cfg, {}
        for name, sub in p_sh.items():
            dims = cfg.attn_dims(tr._window(cfg, kind))
            if (name == "attn" and kind in ATTN_KINDS and split_attn
                    and attn_splits(dims, self.tp)):
                lw[name] = [{k: self.weight(sub[k], attn_regions(dims, self.tp, m)[0][k],
                                            d, m) for k in sub}
                            for m in range(self.tp)]
            elif name == "mlp" and mlp_splits(cfg.d_ff, self.tp):
                lw[name] = [{k: self.weight(sub[k], mlp_regions(cfg.d_ff, self.tp, m)[k],
                                            d, m) for k in sub}
                            for m in range(self.tp)]
            elif name == "moe":
                lw[name] = _LayerMoE(self.whole(sub, d), layer)
            else:
                lw[name] = self.whole(sub, d)
        return lw

    def at(self, d: int, whole_attn=(), encoder=True) -> dict:
        """The parameters as data position d's computation reads them: the
        embedding, the head and the final norms gathered onto (d, 0) now,
        the layers (``_Gathered``) as they are read; the attention of the
        layers in ``whole_attn`` is gathered whole. ``encoder`` False leaves
        the encoder out (decode does not run it)."""
        cfg, p = self.cfg, self.params
        skip = ("layers", "encoder") + (() if encoder else ("enc_norm",))
        out = {k: self.whole(v, d) for k, v in p.items() if k not in skip}
        out["layers"] = _Gathered(self, d, tr.layer_kinds(cfg), p["layers"], whole_attn)
        if "encoder" in p and encoder:
            out["encoder"] = _Gathered(self, d, ["enc"] * len(p["encoder"]), p["encoder"])
        return out

    # ---- the layer's attention and MLP, split (``transformer.LayerOps``) -------

    def ops(self, d: int, rows=None) -> tr.LayerOps:
        """The ``LayerOps`` of data position d (whose batch rows are
        ``rows``, for the caches)."""
        return tr.LayerOps(attn_forward=functools.partial(self._attn_forward, d),
                           attn_prefill=functools.partial(self._attn_cached, d, rows, None),
                           attn_decode=functools.partial(self._attn_decode, d, rows),
                           mlp_forward=functools.partial(self._mlp_forward, d),
                           moe_forward=functools.partial(self._moe_forward, d))

    def spread(self, h: torch.Tensor, d: int) -> list:
        """h on each model position of data position d; in training the
        backward sums their gradients onto (d, 0), logged there."""
        if self.tp > 1 and h.requires_grad and torch.is_grad_enabled():
            nbytes = h.nbytes
            h.register_hook(lambda g: self.note(d, 0, {"kind": "all-reduce",
                                                       "bytes": nbytes, "n": self.tp}))
        return [h.to(self.dev(d, m)) for m in range(self.tp)]

    def partial_sum(self, parts, d: int) -> torch.Tensor:
        """The model positions' partial outputs summed in position order on
        (d, 0)."""
        dev0, acc = self.dev(d, 0), None
        for part in parts:
            part = part.to(dev0)
            acc = part if acc is None else acc + part
        if self.tp > 1:
            self.note(d, 0, {"kind": "all-reduce", "bytes": acc.nbytes, "n": self.tp})
        return acc

    def _attn_forward(self, d, w, dims, h, causal=True, backend=None) -> torch.Tensor:
        if not isinstance(w, list):
            return attn_forward(w, dims, h, causal=causal, backend=backend)
        return self.partial_sum(
            [attn_forward(w[m], attn_regions(dims, self.tp, m)[1], hm, causal=causal,
                          backend=backend)
             for m, hm in enumerate(self.spread(h, d))], d)

    def _mlp_forward(self, d, w, h, activation, glu) -> torch.Tensor:
        if not isinstance(w, list):
            return mlp_forward(w, h, activation, glu)
        return self.partial_sum([mlp_forward(w[m], hm, activation, glu)
                                  for m, hm in enumerate(self.spread(h, d))], d)

    def _moe_forward(self, d, p, dims, h, capacity_override=None) -> tuple:
        """``moe.moe_forward`` of data position d's tokens as a part of the
        whole batch: the first time (d, layer) routes, it reads the counts
        of the positions before it (an all-gather of every position's
        counts, logged) and adds its own; later routings of it (remat's
        recompute, the differentiated pass after the routing pass) reuse
        that prior, and once every position has routed the aux loss reads
        the batch's ce."""
        if self.moe_tokens is None:
            return moe_mod.moe_forward(p, dims, h, capacity_override=capacity_override)
        e, n_slots = dims.n_experts, dims.n_slots or dims.n_experts
        key, first = (d, p.layer), (d, p.layer) not in self.moe_priors
        if first:
            counts = self.moe_counts.get(p.layer)
            if counts is None:
                counts = (torch.zeros(e, dtype=torch.long, device=h.device),
                          torch.zeros(n_slots, dtype=torch.long, device=h.device))
            self.moe_priors[key] = moe_mod.RoutePrior(counts[0].to(h.device),
                                                      counts[1].to(h.device),
                                                      self.moe_tokens)
            self.note(d, 0, moe_counts_record(dims, self.moe_data))
        prior = self.moe_priors[key]
        if self.moe_settled:
            ce = self.moe_counts[p.layer][0].to(h.device, torch.float32)
            prior = prior._replace(ce=ce / (self.moe_tokens * dims.top_k))
        r = moe_mod.route(p, dims, h, None, capacity_override, prior)
        if first:
            self.moe_counts[p.layer] = (
                prior.expert_counts + torch.bincount(r.expert_ids.reshape(-1), minlength=e),
                prior.slot_counts + torch.bincount(r.slot.reshape(-1), minlength=n_slots))
        return moe_mod.moe_apply(p, dims, h, r, None, prior), r.aux

    def _attn_cached(self, d, rows, pos, w, dims, h, c, backend=None) -> tuple:
        """``attn_prefill`` (``pos`` None) or ``attn_decode`` with ``c``'s
        ``k``/``v`` ``Sharded``: each position reads its region of them (its
        rows, its KV heads where the attention splits) and writes it back
        (decode: only the slot it wrote)."""
        slot = None
        if pos is not None:
            s_max = c["k"].shape[1]
            slot = pos % s_max if dims.window else min(max(pos, 0), s_max - 1)
        if isinstance(w, list):
            split = [(w[m], *attn_regions(dims, self.tp, m)[1:], m) for m in range(self.tp)]
        else:
            split = [(w, dims, None, 0)]
        parts = []
        for wm, dims_m, kv, m in split:
            region = (rows, None, kv)
            cm = self.cache_in(c, ("k", "v"), region, d, m)
            hm = h.to(self.dev(d, m))
            if pos is None:
                out, cm = attn_prefill(wm, dims_m, hm, cm, backend)
            else:
                out, cm = attn_decode(wm, dims_m, hm, cm, pos)
            self.cache_out(c, cm, region, d, m, slot)
            parts.append(out)
        return (self.partial_sum(parts, d) if len(parts) > 1 else parts[0]), c

    def _attn_decode(self, d, rows, w, dims, h, c, pos) -> tuple:
        if not isinstance(w, list) and _seq_sharded(c["k"]):
            s_max = c["k"].shape[1]
            slot = pos % s_max if dims.window else min(max(pos, 0), s_max - 1)
            return self.seq_shard_decode(w, dims, h, c, d, rows, pos, slot), c
        return self._attn_cached(d, rows, pos, w, dims, h, c)

    # ---- caches ------------------------------------------------------------

    def cache_in(self, c_sh: dict, names, region, d: int, m: int) -> dict:
        """The caches' ``region`` on position (d, m): the stored block itself
        where the region is one (so the layer writes the storage)."""
        out = {}
        for k in names:
            sh = c_sh[k]
            self.note(d, m, gather_record(sh.shape, sh.dtype, sh.spec, self.mesh, region,
                                          position(self.mesh, d, m)))
            out[k] = sh.read(region, self.dev(d, m))
        return out

    def cache_out(self, c_sh: dict, c: dict, region, d: int, m: int, slot=None) -> None:
        """Write the caches in ``c`` back over ``region`` (for a decode step
        only ``slot`` of the sequence, the one ``attn_decode`` wrote); a
        region of other positions' blocks moves the bytes its read did."""
        for k, t in c.items():
            sh = c_sh[k]
            reg, val = region, t
            if slot is not None and k in ("k", "v"):
                reg = (region[0], (slot, slot + 1)) + tuple(region[2:])
                val = t[:, slot:slot + 1]
            self.note(d, m, gather_record(sh.shape, sh.dtype, sh.spec, self.mesh, reg,
                                          position(self.mesh, d, m)))
            sh.write(reg, val)

    def layer_cache(self, c_sh: dict, d: int, rows) -> dict:
        """A layer's cache as ``_layer_prefill``/``_layer_decode`` read it:
        ``k``/``v`` ``Sharded`` (``ops`` reads them), every other entry
        data position d's rows on (d, 0)."""
        local = self.cache_in(c_sh, [k for k in c_sh if k not in ("k", "v")], (rows,),
                              d, 0)
        return dict(local, **{k: c_sh[k] for k in ("k", "v") if k in c_sh})

    def layer_cache_out(self, c_sh: dict, c: dict, d: int, rows, decode: bool) -> None:
        """Write back what the layer wrote of ``layer_cache``'s entries:
        recurrent states, and in a prefill the encoder's keys and values."""
        keep = ("k", "v", "xk", "xv") if decode else ("k", "v")
        self.cache_out(c_sh, {k: t for k, t in c.items() if k not in keep}, (rows,), d, 0)

    def seq_shard_decode(self, w, dims, h, c_sh, d, rows, pos, slot) -> torch.Tensor:
        """One token's attention over a cache whose sequence is split over
        the model positions: each attends over its slice; the (max, sum,
        output) partials are combined in position order on (d, 0)."""
        b, dev0 = h.shape[0], self.dev(d, 0)
        positions = torch.full((b, 1), pos, device=h.device)
        q, k, v = _project_qkv(w, dims, h, positions)
        self.cache_out(c_sh, {"k": k, "v": v}, (rows, (slot, slot + 1)), d, 0)
        groups = dims.n_heads // dims.n_kv_heads
        span = c_sh["k"].local_shape[1]
        acc = None
        for m in range(self.tp):
            dev = self.dev(d, m)
            lo, hi = m * span, (m + 1) * span
            c = self.cache_in(c_sh, ("k", "v"), (rows, (lo, hi)), d, m)
            kk = c["k"].repeat_interleave(groups, 2).float()
            vv = c["v"].repeat_interleave(groups, 2).float()
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float().to(dev), kk) * (
                dims.d_head ** -0.5)
            valid = torch.arange(lo, hi, device=dev) <= pos
            logits = torch.where(valid, logits, -1e30)
            mx = logits.amax(dim=-1, keepdim=True)
            e = torch.exp(logits - mx)
            part = (mx.to(dev0), e.sum(dim=-1, keepdim=True).to(dev0),
                    torch.einsum("bhqk,bkhd->bhqd", e, vv).to(dev0))
            if acc is None:
                acc = part
            else:
                top = torch.maximum(acc[0], part[0])
                a, z = torch.exp(acc[0] - top), torch.exp(part[0] - top)
                acc = (top, acc[1] * a + part[1] * z, acc[2] * a + part[2] * z)
        if self.tp > 1:
            self.note(d, 0, {"kind": "all-reduce", "n": self.tp,
                             "bytes": sum(t.nbytes for t in acc)})
        out = (acc[2] / acc[1]).transpose(1, 2).to(h.dtype)
        out = out.reshape(b, 1, dims.n_heads * dims.d_head)
        return out @ w["wo"].to(h.dtype)

    # ---- gradients ---------------------------------------------------------

    def scatter_grads(self, acc: dict, grads, d: int) -> None:
        """Add each of data position d's uses' gradients into the blocks it
        was gathered from (f32 accumulators on each block's home device), in
        use order; note which data positions reach (0, 0)'s blocks."""
        pos0 = position(self.mesh, 0, 0)
        for (sh, region, _), g in zip(self.uses, grads):
            if g is None:
                continue
            region = tuple(region) + (None,) * (sh.ndim - len(region))
            region = tuple((0, n) if r is None else r for r, n in zip(region, sh.shape))
            for block in sh.blocks():
                src, dst = [], []
                for (lo, hi), (blo, bhi) in zip(region, sh.region(block)):
                    a, z = max(lo, blo), min(hi, bhi)
                    if a >= z:
                        break
                    src.append(slice(a - lo, z - lo))
                    dst.append(slice(a - blo, z - blo))
                else:
                    piece = g[tuple(src)].to(sh.home_device(block), torch.float32)
                    acc[(id(sh), block)][tuple(dst)] += piece
                    if block == sh.block_of(pos0):
                        self.reached.setdefault(id(sh), set()).add(d)

    def note_reductions(self, leaves) -> None:
        """Log the reduction of each leaf's block at (0, 0) over the data
        positions whose gradients reached it."""
        for sh in leaves:
            n = len(self.reached.get(id(sh), ()))
            if n > 1:
                self.log.append(reduction_record(sh.spec, self.mesh,
                                                 math.prod(sh.local_shape) * 4, n))


def _seq_sharded(sh: Sharded) -> bool:
    return sh.spec[1] == "model" and get_flag("kv_seq_shard", False)


# ---------------------------------------------------------------------------
# Prefill and decode on a mesh
# ---------------------------------------------------------------------------


def batch_sharded(batch: dict, mesh: Mesh) -> dict:
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    return shard_tree(batch, partition.batch_pspecs(batch, mesh), mesh)


def init_cache(cfg, mesh: Mesh, batch: int, max_seq: int, dtype, seq_shard: bool) -> list:
    """Zero caches of ``transformer.init_cache``'s structure, each leaf
    ``Sharded`` under ``cache_pspecs`` (allocated per block)."""
    specs = tr.init_cache(cfg, batch, max_seq, dtype, device="meta")
    cspecs = partition.cache_pspecs(cfg, specs, mesh, stacked=False, seq_shard=seq_shard)
    return tree_map(lambda t, s: zeros(t.shape, t.dtype, s, mesh), specs, cspecs)


def prefill(cfg, mesh: Mesh, params: dict, batch: dict, max_seq: int,
            compute_dtype=torch.bfloat16, log: Optional[list] = None) -> tuple:
    """``transformer.prefill`` on a mesh: (the last position's logits on
    the first position's device, the cache as ``Sharded`` under
    ``cache_pspecs``). ``params`` is a tree of ``Sharded`` (plain tensors
    are sharded by ``param_pspecs``); ``log`` gets position (0, 0)'s
    collectives."""
    params = shard_tree(params, partition.param_pspecs(cfg, params, mesh), mesh)
    n_rows = torch.as_tensor(batch["tokens"]).shape[0]
    cache = init_cache(cfg, mesh, n_rows, max_seq, compute_dtype, False)
    run = Run(cfg, mesh, params, train=False, log=log)
    shards = data_rows(batch_sharded(batch, mesh), mesh)
    run.route_globally(len(shards), math.prod(torch.as_tensor(batch["tokens"]).shape))
    outs = []
    with torch.no_grad(), mesh_hints(mesh):
        for d, rows, local in shards:
            p, ops = run.at(d), run.ops(d, rows)
            x = tr._embed(p, local["tokens"], compute_dtype)
            enc_out = tr._encode(cfg, p, local, compute_dtype, None, ops)
            for kind, lw, c_sh in zip(tr.layer_kinds(cfg), p["layers"], cache):
                c = run.layer_cache(c_sh, d, rows)
                x = tr._layer_prefill(cfg, kind, lw, x, c, enc_out, None, ops)
                run.layer_cache_out(c_sh, c, d, rows, decode=False)
            outs.append(tr._logits(cfg, p, x[:, -1:]).to(first_device(mesh)))
    return torch.cat(outs), cache


def decode_step(cfg, mesh: Mesh, params: dict, cache: list, token, pos: int,
                seq_shard_kv: bool = False, compute_dtype=torch.bfloat16,
                log: Optional[list] = None) -> tuple:
    """``transformer.decode_step`` on a mesh: (logits [B, 1, V] on the
    first position's device, the cache written in place). The cache is
    ``prefill``'s, or plain tensors sharded here by
    ``cache_pspecs(seq_shard=seq_shard_kv)``; ``seq_shard_kv`` runs
    distributed flash-decoding over the model positions."""
    params = shard_tree(params, partition.param_pspecs(cfg, params, mesh), mesh)
    cache = shard_tree(cache, partition.cache_pspecs(cfg, cache, mesh, stacked=False,
                                                     seq_shard=seq_shard_kv), mesh)
    run = Run(cfg, mesh, params, train=False, log=log)
    shards = data_rows(batch_sharded({"token": token}, mesh), mesh)
    n_rows = torch.as_tensor(token).shape[0]
    run.route_globally(len(shards), n_rows)
    dropless = n_rows * cfg.moe.top_k if cfg.moe else None  # the whole batch's
    outs = []
    with torch.no_grad(), mesh_hints(mesh, kv_seq_shard=seq_shard_kv):
        whole = [i for i, c in enumerate(cache) if "k" in c and _seq_sharded(c["k"])]
        for d, rows, local in shards:
            p, ops = run.at(d, whole, encoder=False), run.ops(d, rows)
            x = tr._embed(p, local["token"], compute_dtype)[:, None]
            for kind, lw, c_sh in zip(tr.layer_kinds(cfg), p["layers"], cache):
                c = run.layer_cache(c_sh, d, rows)
                x = tr._layer_decode(cfg, kind, lw, x, c, pos, None, dropless, ops)
                run.layer_cache_out(c_sh, c, d, rows, decode=True)
            outs.append(tr._logits(cfg, p, x).to(first_device(mesh)))
    return torch.cat(outs), cache


# ---------------------------------------------------------------------------
# Trees of Sharded
# ---------------------------------------------------------------------------


def shard_tree(tree, specs, mesh: Mesh):
    """Every leaf of ``tree`` as ``Sharded`` under its spec (a leaf already
    ``Sharded`` is kept)."""
    return tree_map(lambda t, s: t if isinstance(t, Sharded) else partition.shard(
        torch.as_tensor(t), s, mesh), tree, specs)


def unshard_tree(tree, device=None):
    return tree_map(lambda s: partition.unshard(s, device), tree)


def zeros(shape, dtype, spec, mesh: Mesh) -> Sharded:
    """A ``Sharded`` of zeros, each block allocated on its devices only."""
    out = Sharded(shape, spec, mesh, {}, dtype)
    for pos in mesh.positions():
        key = (out.block_of(pos), str(mesh.device(pos)))
        if key not in out.copies:
            out.copies[key] = torch.zeros(out.local_shape, dtype=dtype,
                                          device=mesh.device(pos))
    return out


def data_rows(batch_sh: dict, mesh: Mesh) -> list:
    """[(data position, its rows (lo, hi), its batch on (d, 0))] for the
    data positions the batch's spec splits rows over (one when the rows do
    not divide)."""
    first = next(iter(batch_sh.values()))
    n_rows = first.shape[0]
    n_blocks = n_rows // first.local_shape[0]
    out = []
    for d in range(n_blocks):
        pos = position(mesh, d, 0)
        rows = (d * n_rows // n_blocks, (d + 1) * n_rows // n_blocks)
        out.append((d, rows, {k: sh.local(pos) for k, sh in batch_sh.items()}))
    return out


def program_collectives(cfg, mesh: Mesh, kind: str, batch: int, seq: int,
                        seq_shard: bool = False, compute_dtype=torch.bfloat16,
                        param_dtype=torch.bfloat16) -> list:
    """The collectives position (0, 0) takes part in over one step of
    ``kind`` (train, prefill, decode at position ``seq - 1``; ``forward``,
    a forward without caches or gradients) at ``batch`` × ``seq``, as
    ``Run`` logs them, walked from the specs without running anything: the
    dry-run's wire bytes. Each MoE layer's routing over several data
    positions all-gathers their choice counts; a train step of a MoE model
    first routes in a forward pass (``steps.mesh_value_and_grad``), whose
    collectives come first. In a train step each partial sum
    comes again in the backward (its input's gradient), and the gradients'
    reductions follow. Remat's recompute sums the attention's partials
    again but not the MLP's: it stops once it has remade what the backward
    saved (``torch.utils.checkpoint``'s early stop), and the MLP's sum, the
    layer's last op, feeds only the next layer, which saved its input."""
    tp = mesh.shape["model"]
    specs = tr.param_specs(cfg)
    pspecs = partition.param_pspecs(cfg, specs, mesh)
    _, dp_size = partition._dp_of(mesh)
    rows = batch // dp_size if batch % dp_size == 0 else batch
    n_data = batch // rows
    pos0 = position(mesh, 0, 0)
    log = []
    if kind == "train" and cfg.moe is not None and n_data > 1:  # the routing pass
        log.extend(program_collectives(cfg, mesh, "forward", batch, seq, seq_shard,
                                       compute_dtype, param_dtype))

    def move(shape, dtype, spec, region):
        rec = gather_record(shape, dtype, spec, mesh, region, pos0)
        if rec is not None:
            log.append(rec)

    def whole(tree, stree):
        for path, leaf in flatten_with_paths(tree).items():
            move(leaf.shape, param_dtype, spec_at(stree, path), ())

    def partial(s, recomputed):
        sums = 1 if kind != "train" else 2 + (cfg.remat and recomputed)
        if tp > 1:
            log.extend([{"kind": "all-reduce", "n": tp,
                         "bytes": rows * s * cfg.d_model * _elt(compute_dtype)}] * sums)

    def split(sub, ssub, regions):
        for k, leaf in sub.items():
            move(leaf.shape, param_dtype, ssub[k], regions[k])

    serve = kind in ("prefill", "decode")
    caches = tr.init_cache(cfg, batch, seq, compute_dtype, device="meta") if serve else None
    cspecs = (partition.cache_pspecs(cfg, caches, mesh, stacked=False, seq_shard=seq_shard)
              if serve else None)
    decode = kind == "decode"
    s_tok = 1 if decode else seq
    r = (0, rows)

    def io(c, cs, names, region):
        for k in names:
            move(c[k].shape, c[k].dtype, cs[k], region)

    def layer(lkind, p, ps, s, c=None, cs=None, remat=True):
        dims = cfg.attn_dims(tr._window(cfg, lkind))
        seq_dec = (decode and seq_shard and c is not None and "k" in c
                   and cs["k"][1] == "model")
        tp_attn = lkind in ATTN_KINDS and not seq_dec and attn_splits(dims, tp)
        for name, sub in p.items():  # the layer's weights, as Run.layer_weights
            if name == "attn" and tp_attn:
                split(sub, ps[name], attn_regions(dims, tp, 0)[0])
            elif name == "mlp" and mlp_splits(cfg.d_ff, tp):
                split(sub, ps[name], mlp_regions(cfg.d_ff, tp, 0))
            else:
                whole(sub, ps[name])
        if c is not None and lkind in ("rglru", "rwkv"):
            io(c, cs, list(c), (r,))
            io(c, cs, list(c), (r,))
        elif c is not None:
            s_max = c["k"].shape[1]
            slot = ((seq - 1) % s_max if dims.window else min(seq - 1, s_max - 1)
                    ) if decode else None
            if seq_dec:
                io(c, cs, ("k", "v"), (r, (slot, slot + 1)))
                io(c, cs, ("k", "v"), (r, (0, s_max // tp)))
                if tp > 1:
                    log.append({"kind": "all-reduce", "n": tp,
                                "bytes": rows * dims.n_heads * (dims.d_head + 2) * 4})
            else:
                kv = attn_regions(dims, tp, 0)[2] if tp_attn else None
                io(c, cs, ("k", "v"), (r, None, kv))
                io(c, cs, ("k", "v"), (r, None if slot is None else (slot, slot + 1), kv))
            if lkind == "xattn":
                io(c, cs, ("xk", "xv"), (r,))
                if not decode:
                    io(c, cs, ("xk", "xv"), (r,))
        if lkind == "attn_moe" and n_data > 1 and kind != "train":
            log.append(moe_counts_record(cfg.moe_dims, n_data))
        if lkind in ATTN_KINDS and tp_attn:
            partial(s, recomputed=remat)
        if "mlp" in p and mlp_splits(cfg.d_ff, tp):
            partial(s, recomputed=False)

    whole({"embed": specs["embed"]}, pspecs)
    if cfg.encoder is not None and not decode:
        for p, ps in zip(specs["encoder"], pspecs["encoder"]):
            layer("enc", p, ps, cfg.encoder.max_source, remat=False)  # not checkpointed
        whole(specs["enc_norm"], pspecs["enc_norm"])
    for i, (lkind, p, ps) in enumerate(zip(tr.layer_kinds(cfg), specs["layers"],
                                           pspecs["layers"])):
        layer(lkind, p, ps, s_tok, caches[i] if serve else None,
              cspecs[i] if serve else None)
    whole(specs["final_norm"], pspecs["final_norm"])
    if not cfg.tie_embeddings:  # a tied head is the embedding, gathered once
        whole({"lm_head": specs["lm_head"]}, pspecs)
    if kind == "train":
        log.extend(grad_reductions(specs, pspecs, mesh))
    return log


def spec_at(spec_tree, path: str):
    """The spec at a leaf's path (``training.tree``'s key) in a tree of
    specs, whose leaves are tuples and so not flattened."""
    node = spec_tree
    for key in path.split("/") if path else ():
        node = node[int(key)] if isinstance(node, list) else node[key]
    return node


def _unread(specs, path: str) -> bool:
    """Whether no forward reads the leaf at ``path``, so that its gradient
    is never summed: an ``xattn`` layer's ``norm2`` (its FFN reads
    ``norm3``)."""
    parts = path.split("/")
    return (len(parts) > 2 and parts[0] == "layers" and parts[2] == "norm2"
            and "norm3" in specs["layers"][int(parts[1])])


def grad_reductions(specs, pspecs, mesh: Mesh) -> list:
    """The gradient reductions position (0, 0) takes part in: each of its
    blocks sums the data positions' contributions (f32,
    ``reduction_record``)."""
    n_data = data_size(mesh)
    if n_data == 1:
        return []
    return [reduction_record(spec_at(pspecs, path), mesh, math.prod(partition.local_shape(
        leaf.shape, spec_at(pspecs, path), mesh)) * 4, n_data)
            for path, leaf in flatten_with_paths(specs).items() if not _unread(specs, path)]
