"""Partition rules: parameter, optimizer, batch and cache specs for a mesh —
the counterpart of ``repro.sharding.partition``, with what GSPMD did for the
JAX package: the local shape of a spec, and the shards of a tensor over the
mesh's positions (``shard``/``unshard``).

Scheme (the JAX package's):
  * TP over ``model``: attention/FFN hidden dims, vocab, heads, experts.
  * FSDP over the data-parallel axes on the non-TP dimension of every large
    matrix (the step gathers it per layer).
  * ZeRO-1: optimizer master/moment state inherits the same spec.
  * Batch over ``('pod','data')`` on the multi-pod mesh.
  * KV caches: batch over DP axes, kv-heads over ``model`` when divisible.

The rules are name-based over the parameter tree's paths. They read the
JAX package's layout (``seg{i}/l{j}`` and ``encoder/l0`` leaves stacked
along a leading layer axis, spec with a leading None), so
``param_pspecs(cfg, transformer.jax_layout(cfg, specs), mesh)`` equals the
JAX package's specs; on the port's own layout (``layers``/``encoder`` lists
of per-layer dicts) each layer's leaf gets the stacked spec without its
leading None.
"""

from __future__ import annotations

import math

import torch

from repro_torch.training.tree import map_with_path


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (whole), an axis name, or a tuple
    of axis names (major first). A tuple, so it compares equal to
    ``tuple(jax.sharding.PartitionSpec(...))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec

# matrices [d_in, F] with F TP-sharded (column-parallel)
_COL = {"wq", "wk", "wv", "w_in", "w_gate", "wr", "wg", "cm_wk", "cm_wr",
        "w_x", "w_gate_branch", "wb"}
# matrices [F, d_out] with F TP-sharded (row-parallel)
_ROW = {"wo", "w_out", "cm_wv"}
# 1-D vectors sized with a TP dim
_VEC_TP = {"bq", "bk", "bv", "w0", "ln_x", "lam", "b_a", "b_i", "conv_b"}
# replicated small tensors
_REPL = {"mu", "mu_x", "cm_mu_k", "cm_mu_r", "w", "b", "q_norm", "k_norm",
         "u", "router", "lora_a", "lora_b", "wa", "conv_w", "w_a", "w_i"}


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def _fit(mesh, shape, *candidates):
    """First candidate spec whose named axes all divide the dims; a spec
    never pads, so non-divisible dims fall back (whisper's 51865 vocab,
    granite's 40 experts)."""
    for cand in candidates:
        ok = True
        for dim, axis in zip(shape, cand):
            if axis is not None and dim % _axis_size(mesh, axis) != 0:
                ok = False
                break
        if ok:
            return cand
    return tuple(None for _ in shape)


def _per_layer(names) -> bool:
    """A leaf of the port's layout inside one layer of a stack."""
    return len(names) > 1 and names[0] in ("layers", "encoder") and names[1].isdigit()


def _rule(names, leaf, dp, mesh) -> P:
    name = names[-1]
    per_layer = _per_layer(names)
    stacked = not per_layer and (any(n.startswith("seg") for n in names)
                                 or "encoder" in names)
    nd = leaf.ndim - (1 if stacked else 0)
    shape = tuple(leaf.shape[1:] if stacked else leaf.shape)

    def wrap(*cands):
        spec = _fit(mesh, shape, *cands)
        return P(None, *spec) if stacked else P(*spec)

    if name == "embed":
        return wrap(("model", dp), (None, dp), ("model", None))
    if name == "lm_head":
        return wrap((dp, "model"), (dp, None), (None, "model"))
    moe_member = "moe" in names
    if moe_member and name in ("w_in", "w_gate"):
        # EP over experts preferred; fallback TP over the ff dim
        return wrap(("model", dp, None), (None, dp, "model"),
                    (None, None, "model"))
    if moe_member and name == "w_out":
        return wrap(("model", None, dp), (None, "model", dp),
                    (None, "model", None))
    if name in _COL and nd == 2:
        return wrap((dp, "model"), (None, "model"), (dp, None))
    if name in _ROW and nd == 2:
        return wrap(("model", dp), ("model", None), (None, dp))
    if name in _VEC_TP and nd == 1:
        return wrap(("model",))
    # everything else (norms, biases, mixes, LoRA, router) replicated
    return wrap(tuple(None for _ in range(nd)))


def param_pspecs(cfg, params_tree, mesh) -> dict:
    """A ``PartitionSpec`` per leaf of ``params_tree`` (tensors, meta or
    real), in a tree of its structure, in either layout (module note)."""
    dp, _ = _dp_of(mesh)
    return map_with_path(lambda path, leaf: _rule(path.split("/"), leaf, dp, mesh),
                         params_tree)


def _dp_of(mesh):
    from repro_torch.launch.mesh import dp_axes

    dp = dp_axes(mesh)
    size = 1
    for a in dp:
        size *= mesh.shape[a]
    return (dp[0] if len(dp) == 1 else dp), size


def batch_pspecs(batch_tree, mesh) -> dict:
    dp, dp_size = _dp_of(mesh)

    def spec(path, leaf):
        if leaf.ndim == 0:
            return P()
        b = dp if leaf.shape[0] % dp_size == 0 else None
        return P(b, *([None] * (leaf.ndim - 1)))

    return map_with_path(spec, batch_tree)


def cache_pspecs(cfg, cache_tree, mesh, stacked: bool = True,
                 seq_shard: bool = False) -> dict:
    """KV caches [B, S, Hkv, dh]: batch over DP; kv heads over model when
    divisible, else head_dim over model when divisible. ``stacked`` means a
    leading layer dim (the JAX package's scanned segments); the port's own
    caches are a list of per-layer dicts, ``stacked=False``.

    ``seq_shard=True`` shards the cache *sequence* over the model axis
    instead: distributed flash-decoding, whose combine moves softmax
    statistics and partial outputs instead of S-sized tensors.
    """
    dp_axes_, dp_size = _dp_of(mesh)
    model_size = mesh.shape["model"]
    lead = (None,) if stacked else ()
    off = 1 if stacked else 0

    def mdl(n):
        return "model" if n % model_size == 0 else None

    def spec_dispatch(path, leaf):
        name = path.split("/")[-1]
        nd = leaf.ndim
        # batch axis shards over dp only when divisible (long_500k has B=1)
        dp = dp_axes_ if leaf.shape[off] % dp_size == 0 else None
        if name in ("k", "v", "xk", "xv"):          # [B, S, H, dh]
            h, dh = leaf.shape[off + 2], leaf.shape[off + 3]
            seq = leaf.shape[off + 1]
            if seq_shard and seq % model_size == 0:
                return P(*lead, dp, "model", None, None)
            if h % model_size == 0:
                return P(*lead, dp, None, "model", None)
            return P(*lead, dp, None, None, mdl(dh))
        if name == "wkv":                            # [B, H, dk, dv]
            return P(*lead, dp, mdl(leaf.shape[off + 1]), None, None)
        if name == "conv":                           # [B, w, dr]
            return P(*lead, dp, None, mdl(leaf.shape[-1]))
        if name == "h":                              # [B, dr]
            return P(*lead, dp, mdl(leaf.shape[-1]))
        if nd >= 1 + off:                            # tm_x/cm_x [B, 1, d]
            return P(*lead, dp, *([None] * (nd - 1 - off)))
        return P(*([None] * nd))

    return map_with_path(spec_dispatch, cache_tree)


def opt_state_pspecs(param_specs) -> dict:
    """ZeRO-1: master/m/v inherit the fully sharded param specs."""
    return {"master": param_specs, "m": param_specs, "v": param_specs,
            "count": P()}


# ---------------------------------------------------------------------------
# What GSPMD did: local shapes and the shards of a tensor over the positions
# ---------------------------------------------------------------------------


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one position's shard of a ``shape`` tensor under
    ``spec`` (every named dim divided by its axes' sizes, which must divide
    it)."""
    shape = tuple(int(s) for s in shape)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, spec):
        n = _axis_size(mesh, entry)
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {entry!r} ({n} positions)")
        out.append(dim // n)
    return tuple(out)


def block_of(pos, spec, mesh) -> tuple:
    """The block (one index per tensor dim) that the position with
    coordinates ``pos`` holds under ``spec``: along a dim named by axes
    (a, b, ...), the row-major index of pos's coordinates on them."""
    coord = dict(zip(mesh.axis_names, pos))
    out = []
    for entry in spec:
        axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + coord[a]
        out.append(idx)
    return tuple(out)


class Sharded:
    """A global tensor stored over a mesh's positions under a spec.

    Each block (the part one position holds) is stored once per distinct
    device among the positions that hold it: positions on one device share
    the tensor, positions on other devices hold copies. ``local(pos)`` is
    the tensor position ``pos`` holds, of ``local_shape(shape, spec)``;
    ``home(block)`` the copy on the first position (row-major) holding it.
    """

    def __init__(self, shape, spec, mesh, copies: dict, dtype):
        self.shape = tuple(int(s) for s in shape)
        self.spec = P(*(tuple(spec) + (None,) * (len(self.shape) - len(spec))))
        self.mesh = mesh
        self.dtype = dtype
        self.local_shape = local_shape(self.shape, self.spec, mesh)
        #: {(block, device str): tensor}
        self.copies = copies

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def block_of(self, pos) -> tuple:
        return block_of(pos, self.spec, self.mesh)

    def blocks(self) -> list:
        """Every block, in the row-major order of its first position."""
        seen = {}
        for pos in self.mesh.positions():
            seen.setdefault(self.block_of(pos), pos)
        return list(seen)

    def home_device(self, block) -> torch.device:
        for pos in self.mesh.positions():
            if self.block_of(pos) == block:
                return self.mesh.device(pos)
        raise KeyError(block)

    def home(self, block) -> torch.Tensor:
        return self.copies[(block, str(self.home_device(block)))]

    def local(self, pos) -> torch.Tensor:
        return self.copies[(self.block_of(pos), str(self.mesh.device(pos)))]

    def region(self, block) -> tuple:
        """The block's ``(lo, hi)`` along every dim of the global tensor."""
        return tuple((b * n, (b + 1) * n) for b, n in zip(block, self.local_shape))

    def set_block(self, block, value: torch.Tensor) -> None:
        """Store ``value`` as ``block`` on every device that holds it."""
        for pos in self.mesh.positions():
            if self.block_of(pos) == block:
                key = (block, str(self.mesh.device(pos)))
                if key not in self.copies or self.copies[key] is not value:
                    self.copies[key] = value.to(self.mesh.device(pos))

    def read(self, region, device) -> torch.Tensor:
        """The global tensor's ``region`` (``(lo, hi)`` per dim; None: the
        whole dim) on ``device``, assembled from the blocks that cover it.
        A region that is exactly one block held on ``device`` returns that
        stored tensor itself, so writing into it writes the storage."""
        region = tuple((0, n) if r is None else r for r, n in zip(
            tuple(region) + (None,) * (self.ndim - len(region)), self.shape))
        ranges = []
        for (lo, hi), n in zip(region, self.local_shape):
            ranges.append(range(lo // n, -(-hi // n)))
        dev = torch.device(device)

        def assemble(dim, prefix):
            if dim == self.ndim:
                block = tuple(prefix)
                key = (block, str(dev))
                src = self.copies.get(key)
                if src is None:
                    src = self.home(block)
                idx = []
                for (lo, hi), b, n in zip(region, block, self.local_shape):
                    idx.append(slice(max(lo - b * n, 0), min(hi - b * n, n)))
                return src[tuple(idx)]
            parts = [assemble(dim + 1, prefix + [b]) for b in ranges[dim]]
            return parts[0] if len(parts) == 1 else torch.cat(
                [p.to(dev) for p in parts], dim=dim)

        out = assemble(0, [])
        return out if out.device == dev else out.to(dev)

    def write(self, region, value: torch.Tensor) -> None:
        """Write ``value`` (the global tensor's ``region``) into every copy
        of every block it covers, in place."""
        region = tuple((0, n) if r is None else r for r, n in zip(
            tuple(region) + (None,) * (self.ndim - len(region)), self.shape))
        for (block, _), dst in self.copies.items():
            src_idx, dst_idx = [], []
            for (lo, hi), b, n in zip(region, block, self.local_shape):
                a, z = max(lo, b * n), min(hi, (b + 1) * n)
                if a >= z:
                    break
                src_idx.append(slice(a - lo, z - lo))
                dst_idx.append(slice(a - b * n, z - b * n))
            else:
                part = value[tuple(src_idx)]
                if dst.data_ptr() == part.data_ptr() and dst.shape == part.shape:
                    continue  # the region is this stored block itself
                dst[tuple(dst_idx)] = part.to(dst.device, dst.dtype)

    def nbytes_at(self, pos) -> int:
        return self.local(pos).nbytes


def shard(t: torch.Tensor, spec, mesh) -> Sharded:
    """``t`` split into the blocks of ``spec``, each block stored on the
    devices of the positions that hold it (``Sharded``)."""
    spec = tuple(spec) + (None,) * (t.dim() - len(spec))
    out = Sharded(t.shape, spec, mesh, {}, t.dtype)
    for pos in mesh.positions():
        block = out.block_of(pos)
        dev = mesh.device(pos)
        key = (block, str(dev))
        if key not in out.copies:
            idx = tuple(slice(lo, hi) for lo, hi in out.region(block))
            out.copies[key] = t[idx].to(dev, copy=True).contiguous()
    return out


def unshard(s: Sharded, device=None) -> torch.Tensor:
    """The global tensor of ``s`` on ``device`` (default: the first
    position's)."""
    dev = s.mesh.device(s.mesh.positions()[0]) if device is None else device
    return s.read((), dev)


def local_nbytes(shape, dtype, spec, mesh) -> int:
    """Bytes of one position's shard."""
    return math.prod(local_shape(shape, spec, mesh)) * torch.empty(
        (), dtype=dtype).element_size()
