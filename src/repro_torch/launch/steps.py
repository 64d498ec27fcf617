"""Train / prefill / decode step factories, on one device or on a mesh, and
the sharded GCN inference step.

The counterpart of ``repro.launch.steps``. ``make_*`` return a step function
and the meta-device specs of its state (``torch.device("meta")`` tensors:
shapes and dtypes, nothing allocated), as the JAX package returns jitted
functions and ``ShapeDtypeStruct``s. They take a ``launch.mesh.Mesh`` where
the JAX package takes one; a device (or ``None``: the current card) runs the
single-device step, which is the 1 × 1 mesh's computation.

On a mesh the state is stored by ``sharding.partition``'s specs, each
position holding only its block (``partition.Sharded``), and the step runs
``sharding.spmd``: data positions on their rows in order, attention split by
heads and the dense MLP by columns over the model positions (the flash
kernel launched once per model position on its head slice), every other
weight gathered layer by layer, gradients combined over the data positions
in order and weighted by rows, AdamW on each block. ``make_gcn_step`` runs
the AWB schedule's steps over the data positions: on the card, the SpMM
kernels on each position's step range (``spmm_cuda.kernel_plan``); on the
CPU, the JAX package's gather/scatter body in torch ops.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as tr
from repro_torch.sharding import partition, spmd
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.tree import flatten_with_paths, map_with_path, tree_map


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy: logsumexp of the f32 logits minus the
    label's logit, never an f32 log-softmax of the whole logits."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    lab = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - lab.float()).mean()


def _to_dtype_specs(tree, dtype):
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype, device="meta"), tree)


def model_shardings(cfg: tr.ModelConfig, mesh: Optional[Mesh]):
    """(param_specs_bf16, param_pspecs) for the working (bf16) parameters:
    meta-device specs and ``partition.param_pspecs`` on ``mesh``, the
    counterpart of the JAX package's (specs, ``NamedSharding`` tree).
    ``mesh`` None is one device, where nothing is partitioned: the pspecs
    are None."""
    specs = _to_dtype_specs(tr.param_specs(cfg), torch.bfloat16)
    return specs, None if mesh is None else partition.param_pspecs(cfg, specs, mesh)


def _check_batch(batch: dict, batch_specs: dict) -> None:
    for key, spec in batch_specs.items():
        got = batch.get(key)
        if got is None or tuple(got.shape) != tuple(spec.shape):
            raise ValueError(f"batch[{key!r}] is "
                             f"{None if got is None else tuple(got.shape)}; the step "
                             f"was made for {tuple(spec.shape)}")


def value_and_grad(cfg: tr.ModelConfig, params: dict, batch: dict,
                   aux_weight: float = 0.01, backend: Optional[str] = None,
                   compute_dtype=torch.bfloat16) -> tuple:
    """(loss, grads): the loss cross_entropy(logits, labels) + aux_weight ·
    the MoE aux loss of ``model_forward``, and its gradient with respect to
    every parameter (zeros for one the loss does not reach), each in its
    parameter's dtype. ``backend`` selects the attention
    (``kernels.ops.attention``): the flash kernel by default on the card,
    ``"torch"`` for its plain version under autograd. The three parts run
    under the profiler ranges ``train.forward``, ``train.cross_entropy``
    and ``train.backward``."""
    flat = flatten_with_paths(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    live = map_with_path(lambda path, _: leaves[path], params)
    with torch.enable_grad():
        with tracing.span("train.forward"):
            logits, aux = tr.model_forward(cfg, live, batch, backend=backend,
                                           compute_dtype=compute_dtype)
        with tracing.span("train.cross_entropy"):
            loss = cross_entropy(logits, batch["labels"]) + aux_weight * aux
        with tracing.span("train.backward"):
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    by_path = {k: torch.zeros_like(v) if g is None else g
               for (k, v), g in zip(leaves.items(), grads)}
    return loss.detach(), map_with_path(lambda path, _: by_path[path], params)


def make_train_step(cfg: tr.ModelConfig, device=None, batch_specs: Optional[dict] = None,
                    opt_cfg: Optional[opt_mod.AdamWConfig] = None,
                    aux_weight: float = 0.01):
    """Returns ``(train_step, (param_specs, opt_specs))``;
    ``train_step(params, opt_state, batch)`` runs the forward, the backward
    (``value_and_grad``, bf16 compute) and ``adamw_update`` on ``device``
    and returns ``(params, opt_state, metrics)``, the bf16 working
    parameters from the f32 master, ``metrics`` holding ``loss``,
    ``grad_norm`` and ``lr`` as device tensors. ``batch`` holds ``tokens``
    and ``labels`` (and ``source_embed`` for an encoder), checked against
    ``batch_specs``' shapes when given. The attention runs the flash
    kernel on the card (``_FlashAttention``). The optimizer runs under the
    profiler range ``train.optimizer``.

    ``device`` may be a ``Mesh``: then ``train_step`` takes and returns
    ``partition.Sharded`` trees (plain tensors are sharded on the way in)
    and runs ``mesh_value_and_grad`` and ``mesh_adamw_update``, the working
    parameters kept in the dtype they came in and ``metrics`` on the first
    position's device."""
    opt_cfg = opt_cfg or opt_mod.AdamWConfig()
    param_specs, pspecs = model_shardings(
        cfg, device if isinstance(device, Mesh) else None)
    opt_specs = opt_mod.adamw_init(param_specs)
    if isinstance(device, Mesh):
        mesh = device
        ospecs = partition.opt_state_pspecs(pspecs)

        def mesh_train_step(params, opt_state, batch):
            if batch_specs is not None:
                _check_batch(batch, batch_specs)
            params = spmd.shard_tree(params, pspecs, mesh)
            opt_state = spmd.shard_tree(opt_state, ospecs, mesh)
            loss, grads = mesh_value_and_grad(cfg, mesh, params, batch, aux_weight)
            with tracing.span("train.optimizer"):
                params, opt_state, metrics = mesh_adamw_update(opt_cfg, params, grads,
                                                               opt_state)
            return params, opt_state, dict(metrics, loss=loss)

        return mesh_train_step, (param_specs, opt_specs)
    dev = resolve_device(device)

    def train_step(params, opt_state, batch):
        if batch_specs is not None:
            _check_batch(batch, batch_specs)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        loss, grads = value_and_grad(cfg, params, batch, aux_weight)
        with tracing.span("train.optimizer"):
            params, opt_state, metrics = opt_mod.adamw_update(opt_cfg, grads, opt_state)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step, (param_specs, opt_specs)


def make_prefill_step(cfg: tr.ModelConfig, device=None, batch_specs: Optional[dict] = None,
                      max_seq: int = 256):
    """Returns ``(prefill_step, (param_specs,))``; ``prefill_step(params,
    batch)`` is ``transformer.prefill`` on ``device``: (the last position's
    logits, the cache). On a ``Mesh`` it is ``spmd.prefill``: the cache a
    list of dicts of ``partition.Sharded`` under ``cache_pspecs``, the
    logits on the first position's device, and ``prefill_step.log`` the
    last call's collectives at position (0, 0)."""
    specs = (model_shardings(cfg, None)[0],)
    if isinstance(device, Mesh):
        def mesh_prefill_step(params, batch):
            if batch_specs is not None:
                _check_batch(batch, batch_specs)
            mesh_prefill_step.log = []
            return spmd.prefill(cfg, device, params, batch, max_seq,
                                log=mesh_prefill_step.log)

        return mesh_prefill_step, specs
    dev = resolve_device(device)

    def prefill_step(params, batch):
        if batch_specs is not None:
            _check_batch(batch, batch_specs)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        with torch.no_grad():
            return tr.prefill(cfg, params, batch, max_seq=max_seq)

    return prefill_step, specs


def make_decode_step(cfg: tr.ModelConfig, device=None, batch: int = 1,
                     max_seq: int = 256, seq_shard_kv: bool = False):
    """Returns ``(decode, (param_specs, cache_specs))``; ``decode(params,
    cache, token, pos)`` is ``transformer.decode_step`` on ``device``, the
    cache written in place. On a ``Mesh`` it is ``spmd.decode_step``: the
    cache the mesh prefill's (``Sharded``; a plain cache is sharded by
    ``cache_pspecs(seq_shard=seq_shard_kv)`` on the way in),
    ``seq_shard_kv`` running distributed flash-decoding over the model
    positions, and ``decode.log`` the last call's collectives at position
    (0, 0); one device ignores ``seq_shard_kv``."""
    cache_specs = tr.init_cache(cfg, batch, max_seq, torch.bfloat16, device="meta")
    specs = (model_shardings(cfg, None)[0], cache_specs)
    if isinstance(device, Mesh):
        def mesh_decode(params, cache, token, pos):
            mesh_decode.log = []
            return spmd.decode_step(cfg, device, params, cache, torch.as_tensor(token),
                                    int(pos), seq_shard_kv, log=mesh_decode.log)

        return mesh_decode, specs
    dev = resolve_device(device)

    def decode(params, cache, token, pos):
        with torch.no_grad():
            return tr.decode_step(cfg, params, cache, torch.as_tensor(token).to(dev),
                                  int(pos))

    return decode, specs


# ---------------------------------------------------------------------------
# Training on a mesh (sharding.spmd)
# ---------------------------------------------------------------------------


def mesh_value_and_grad(cfg: tr.ModelConfig, mesh: Mesh, params: dict, batch: dict,
                        aux_weight: float = 0.01, compute_dtype=torch.bfloat16,
                        log: Optional[list] = None) -> tuple:
    """``value_and_grad`` on a mesh: (the loss on the first position's
    device, the gradient as a tree of f32 ``partition.Sharded``, each block
    on its home device). ``params`` is a tree of ``Sharded`` (plain tensors
    are sharded by ``param_pspecs``); the batch's rows split over the data
    positions, each running ``transformer.model_forward`` on the weights it
    gathers (``spmd.Run``), their losses weighted by their share of the
    rows and summed in order, their gradients summed onto the blocks in
    order. A MoE model routes the whole batch as one device does: a
    forward without gradients first routes every data position in order
    (range ``train.routing``), so that ranks, capacity and drops are the
    batch's and each position's aux loss, weighted by its share, sums to
    the batch's. ``log`` gets position (0, 0)'s collectives. Runs under the
    profiler ranges of ``value_and_grad``."""
    params = spmd.shard_tree(params, partition.param_pspecs(cfg, params, mesh), mesh)
    flat = flatten_with_paths(params)
    acc = {(id(sh), block): torch.zeros(sh.local_shape, dtype=torch.float32,
                                        device=sh.home_device(block))
           for sh in flat.values() for block in sh.blocks()}
    shards = spmd.data_rows(spmd.batch_sharded(batch, mesh), mesh)
    n_rows = sum(hi - lo for _, (lo, hi), _ in shards)
    run = spmd.Run(cfg, mesh, params, train=True, log=log)
    dev0, loss = spmd.first_device(mesh), None
    if cfg.moe is not None and len(shards) > 1:
        run.route_globally(len(shards), n_rows * shards[0][2]["tokens"].shape[1])
        with torch.no_grad(), spmd.mesh_hints(mesh), tracing.span("train.routing"):
            for d, _, rows in shards:
                tr.model_forward(cfg, run.at(d), rows, compute_dtype=compute_dtype,
                                 ops=run.ops(d))
        run.uses, run.moe_settled = [], True
    with spmd.mesh_hints(mesh):
        for d, (lo, hi), rows in shards:
            run.uses = []
            with torch.enable_grad():
                with tracing.span("train.forward"):
                    logits, aux = tr.model_forward(cfg, run.at(d), rows,
                                                   compute_dtype=compute_dtype,
                                                   ops=run.ops(d))
                with tracing.span("train.cross_entropy"):
                    part = (cross_entropy(logits, rows["labels"]) + aux_weight * aux) * (
                        (hi - lo) / n_rows)
                del logits
                with tracing.span("train.backward"):
                    grads = torch.autograd.grad(part, [u[2] for u in run.uses],
                                                allow_unused=True)
            run.scatter_grads(acc, grads, d)
            del grads
            part = part.detach().to(dev0)
            loss = part if loss is None else loss + part
    run.uses = []
    run.note_reductions(flat.values())

    def grad_of(sh):
        return partition.Sharded(sh.shape, sh.spec, mesh, {
            (block, str(sh.home_device(block))): acc[(id(sh), block)]
            for block in sh.blocks()}, torch.float32)

    return loss, map_with_path(lambda path, _: grad_of(flat[path]), params)


def mesh_adamw_update(opt_cfg: opt_mod.AdamWConfig, params: dict, grads: dict,
                      opt_state: dict) -> tuple:
    """``adamw_update`` on a mesh: AdamW on each block at its home device,
    the clip reading the norm of the whole gradient (the ordered sum of the
    blocks' squares). Returns new ``Sharded`` trees ``(params, opt_state,
    metrics)``, the working parameters in their own dtype and ``metrics``
    on the first position's device; the inputs are left as they were."""
    flat, flat_g = flatten_with_paths(params), flatten_with_paths(grads)
    keys = [(path, sh, block) for path, sh in flat.items() for block in sh.blocks()]
    dev0 = spmd.first_device(next(iter(flat.values())).mesh)
    sq = None
    for path, _, block in keys:
        g = flat_g[path].home(block)
        part = torch.sum(g * g).to(dev0)
        sq = part if sq is None else sq + part
    gnorm = torch.sqrt(sq)
    opt_flat = {k: flatten_with_paths(opt_state[k]) for k in ("master", "m", "v")}
    count = opt_state["count"]

    def fresh(sh, dtype):
        return partition.Sharded(sh.shape, sh.spec, sh.mesh, {}, dtype)

    new = {k: {path: fresh(sh, sh.dtype if k == "params" else torch.float32)
               for path, sh in flat.items()}
           for k in ("params", "master", "m", "v")}
    by_dev: dict = {}
    for key in keys:
        by_dev.setdefault(str(key[1].home_device(key[2])), []).append(key)
    new_count = fresh(count, count.dtype)
    lr = None
    for dev_name, group in by_dev.items():
        dev = torch.device(dev_name)
        names = [str(i) for i in range(len(group))]
        g_dev = {n: flat_g[path].home(block) for n, (path, _, block) in zip(names, group)}
        state = {k: {n: opt_flat[k][path].home(block)
                     for n, (path, _, block) in zip(names, group)}
                 for k in ("master", "m", "v")}
        state["count"] = count.read((), dev)
        p_new, s_new, metrics = opt_mod.adamw_update(
            opt_cfg, g_dev, state, param_dtype=group[0][1].dtype, gnorm=gnorm.to(dev))
        for n, (path, _, block) in zip(names, group):
            new["params"][path].set_block(block, p_new[n])
            for k in ("master", "m", "v"):
                new[k][path].set_block(block, s_new[k][n])
        new_count.set_block((), s_new["count"])
        lr = metrics["lr"] if lr is None else lr

    def tree(k):
        return map_with_path(lambda path, _: new[k][path], params)

    opt_new = {"master": tree("master"), "m": tree("m"), "v": tree("v"), "count": new_count}
    return tree("params"), opt_new, {"grad_norm": gnorm, "lr": lr.to(dev0)}


# ---------------------------------------------------------------------------
# GCN (the paper's own workload) on a mesh
# ---------------------------------------------------------------------------


def make_gcn_step(mesh: Mesh, n_nodes: int, n_feat: int, hidden: int, n_classes: int,
                  n_steps: int, nnz_per_step: int, rows_per_window: int):
    """Sharded 2-layer GCN inference through an AWB schedule: schedule steps
    (equal work) split over the data positions — the device-level form of
    the paper's balanced PE partition — and features/hidden over model.

    Returns ``(fn, arg_specs)``: ``fn(x, w1, w2, val, lrow, lcol, win, cblk,
    row_map)`` with the JAX package's nine arrays and padding (feature and
    hidden widths to multiples of the model axis, steps to the data
    positions'); ``lcol`` is the global column (one column block) and
    ``cblk`` is not read, as in the JAX package. ``arg_specs`` are
    meta-device tensors of the padded shapes.

    Per layer: each model position multiplies its slice of the features (or
    hidden) by its rows of the weight and the partials are summed in order
    on each data position's first position; each data position runs its
    step range of the SpMM — on the card the window and epilogue kernels on
    the range's ``spmm_cuda.kernel_plan`` (one launch each), on the CPU the
    JAX package's gather/scatter body — and the data positions' ``[n,
    width]`` partials are summed in order on the first position. Plans are
    kept for the last schedule arrays seen (``fn.plans``)."""
    from repro_torch.core.executor import _runs_kernels

    n_data, tp = spmd.data_size(mesh), mesh.shape["model"]
    r, k = rows_per_window, nnz_per_step

    def pad_to(x, m):
        return -(-x // m) * m

    n_feat_p, hidden_p = pad_to(n_feat, tp), pad_to(hidden, tp)
    n_steps_p = pad_to(n_steps, n_data)
    per = n_steps_p // n_data
    devs = [[mesh.device(spmd.position(mesh, d, m)) for m in range(tp)]
            for d in range(n_data)]
    plans: dict = {}

    def dense(x, w, d):
        """x @ w split over the model positions by x's columns (w's rows),
        the partials summed in order on (d, 0)."""
        width = x.shape[1]
        acc = None
        for m in range(tp):
            lo, hi = m * width // tp, (m + 1) * width // tp
            part = (x[:, lo:hi].to(devs[d][m]) @ w[lo:hi].to(devs[d][m])).to(devs[d][0])
            acc = part if acc is None else acc + part
        return acc

    def step_plan(arrays, d):
        key = (d,) + tuple((t.data_ptr(), t._version, tuple(t.shape)) for t in arrays)
        if key not in plans:
            from repro_torch.core.schedule import Schedule
            from repro_torch.kernels import spmm_cuda

            val, lrow, lcol, win, row_map = (t.cpu().numpy() for t in arrays)
            sched = Schedule(win_id=win, col_block=np.zeros_like(win),
                             val=val.reshape(-1), local_row=lrow.reshape(-1),
                             local_col=lcol.reshape(-1), row_map=row_map,
                             shape=(n_nodes, n_nodes), nnz_per_step=k,
                             rows_per_window=r, cols_per_block=n_nodes,
                             nnz=int(np.count_nonzero(val)), n_evil_chunks=0)
            plan = spmm_cuda.kernel_plan(sched, np.arange(d * per, (d + 1) * per))
            dev = devs[d][0]
            steps = spmm_cuda.DeviceSteps(
                *(torch.from_numpy(plan[f]).to(dev) for f in spmm_cuda.DEVICE_FIELDS),
                shape=(n_nodes, n_nodes), n_parts=int(plan["part_ptr"][-1]))
            if len(plans) >= 2 * n_data:
                plans.clear()
            plans[key] = steps
        return plans[key]

    def spmm_range(b, arrays, d):
        """Data position d's step range of A @ b: an [n, width] partial."""
        val, lrow, lcol, win, row_map = arrays
        dev = devs[d][0]
        if _runs_kernels(dev):
            from repro_torch.kernels import spmm_cuda

            steps = step_plan(arrays, d)
            part = spmm_cuda.spmm_window(steps, b.contiguous())
            return spmm_cuda.spmm_epilogue(steps, part, b.dtype)
        lo, hi = d * per, (d + 1) * per
        val, lrow, lcol, win = (t[lo:hi].to(dev) for t in (val, lrow, lcol, win))
        gcol = torch.clamp(lcol, max=b.shape[0] - 1).long()
        slot = (win[:, None].long() * r + lrow.long()).reshape(-1)
        gathered = b[gcol.reshape(-1)] * val.reshape(-1)[:, None]
        out_perm = torch.zeros((row_map.shape[0], b.shape[1]), dtype=b.dtype, device=dev)
        out_perm.index_add_(0, slot, gathered)
        row_map = row_map.to(dev)
        valid = row_map >= 0
        out = torch.zeros((n_nodes, b.shape[1]), dtype=b.dtype, device=dev)
        return out.index_add_(0, row_map[valid].long(), out_perm[valid])

    def spmm(b_per_data, arrays):
        acc = None
        for d in range(n_data):
            part = spmm_range(b_per_data[d], arrays, d).to(devs[0][0])
            acc = part if acc is None else acc + part
        return acc

    @torch.no_grad()
    def gcn_infer(x, w1, w2, val, lrow, lcol, win, cblk, row_map):
        del cblk
        arrays = (val, lrow, lcol, win, row_map)
        h = torch.relu(spmm([dense(x, w1, d) for d in range(n_data)], arrays))
        return spmm([dense(h.to(devs[d][0]), w2, d) for d in range(n_data)], arrays)

    #: the DeviceSteps of each data position's range, keyed (d, the
    #: arrays' identities): the card's plans, for callers that check them
    gcn_infer.plans = plans

    def spec(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    specs = (
        spec(n_nodes, n_feat_p),                 # x
        spec(n_feat_p, hidden_p),                # w1
        spec(hidden_p, n_classes),               # w2
        spec(n_steps_p, k),                      # val
        spec(n_steps_p, k, dtype=torch.int32),   # lrow (slot-local)
        spec(n_steps_p, k, dtype=torch.int32),   # lcol (global column)
        spec(n_steps_p, dtype=torch.int32),      # win
        spec(n_steps_p, dtype=torch.int32),      # cblk
        spec(n_steps_p * r, dtype=torch.int32),  # row_map
    )
    return gcn_infer, specs
