"""Multi-pod dry-run: every (architecture × shape × mesh) cell counted on the
meta device, with memory, cost and collective records per device — the
counterpart of ``repro.launch.dryrun``, in H100 terms.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --gcn   # every cell

Outputs one JSON per cell under ``results/dryrun_torch/`` (cached; --force
to redo) and a summary line per cell. Nothing is allocated and no card is
needed: the production meshes' positions are on the meta device.

A cell counts the program of one position, position (0, 0), as the sharded
steps of ``launch.steps`` split it (``sharding.spmd``): its rows of the
batch (rows / data positions, when they divide) and, where the step splits
them over the model axis, its share of the attention heads and KV heads
and of the dense MLP's width; the embedding, the head and every unsplit
layer whole. That program runs on meta tensors at those local shapes:

* ``flops`` from ``torch.utils.flop_counter.FlopCounterMode`` (forward and
  backward, remat's recompute included);
* ``bytes``, every non-view aten op's operand and output bytes, and
  ``hbm_bytes_model`` (``roofline.analysis.hbm_bytes_from_ops``), from a
  ``TorchDispatchMode`` log of the ops (``OpLog``);
* ``temp_bytes``, the peak of the live bytes of the tensors the program
  made (``OpLog``);
* ``argument_bytes``/``output_bytes``/``alias_bytes``, one position's
  shards of the step's inputs and outputs (``partition.local_shape``);
* ``collectives``, the wire bytes of what the step gathers and sums
  (``spmd.program_collectives``), by ``roofline.analysis.collective_bytes``.

The attention is counted as the card runs it: the flash kernel's operator
(``flash_attention_cuda.flash_attention_op``), which reads q, k and v once,
writes its output once and does 4·B·H·D FLOPs a visible (query, key) pair,
forming no S × S tensor (``attn_chunk`` is ignored there, as on the card);
in a train step its backward, ``attention_vjp`` in torch ops, whose f32
S × S temporaries are counted as they come. The JAX package extrapolates its totals from per-unit lowerings because XLA
counts a scanned layer stack's body once; the port runs every layer, so
``*_extrap`` keys equal the full counts and no unit is lowered apart.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs as cfgs
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as tr
from repro_torch.roofline import analysis as ra
from repro_torch.sharding import partition, spmd
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.tree import flatten_with_paths, tree_map

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
META = torch.device("meta")
BF16 = torch.bfloat16


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpLog(TorchDispatchMode):
    """Every aten op a program runs: ``{"op", "in_bytes", "out_bytes"}``
    (view ops, which move nothing, left out), and the peak of the live bytes
    of the tensors the ops made (each freed when its last reference goes)."""

    def __init__(self):
        super().__init__()
        self.ops: list = []
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        if outs and all(t._is_view() for t in outs):
            return out
        ins = [t for t in pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        self.ops.append({"op": func.overloadpacket.__name__,
                         "in_bytes": sum(_nbytes(t) for t in ins),
                         "out_bytes": sum(_nbytes(t) for t in outs)})
        for t in outs:
            if t._is_view() or any(t is i for i in ins):
                continue  # in place, or a view of an input
            n = _nbytes(t)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, n)
        return out


def measure(fn) -> dict:
    """Run ``fn`` (on meta tensors) under the flop counter and the op log:
    ``{"flops", "bytes", "ops", "temp_bytes"}``."""
    with FlopCounterMode(display=False) as fc, OpLog() as log:
        fn()
    return {"flops": float(fc.get_total_flops()),
            "bytes": float(sum(o["in_bytes"] + o["out_bytes"] for o in log.ops)),
            "ops": log.ops, "temp_bytes": log.peak}


# ---------------------------------------------------------------------------
# One position's program
# ---------------------------------------------------------------------------


def local_config(cfg: tr.ModelConfig, mesh) -> tr.ModelConfig:
    """The config of one position's share of the model, as the sharded step
    splits it: heads and KV heads over the model axis where the attention
    splits (``spmd.attn_splits``), the dense MLP's width where it splits
    (``spmd.mlp_splits``; RWKV's channel mix, which reads ``d_ff``, runs
    whole)."""
    tp = mesh.shape["model"]
    kinds = tr.layer_kinds(cfg)
    changes = {"d_head": cfg.head_dim}
    has_attn = cfg.encoder is not None or any(k in spmd.ATTN_KINDS for k in kinds)
    if has_attn and spmd.attn_splits(cfg.attn_dims(None), tp):
        changes.update(n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp)
    if "rwkv" not in kinds and spmd.mlp_splits(cfg.d_ff, tp):
        changes["d_ff"] = cfg.d_ff // tp
    return dataclasses.replace(cfg, **changes)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def _local_rows(batch: int, mesh) -> int:
    _, dp_size = partition._dp_of(mesh)
    return batch // dp_size if batch % dp_size == 0 else batch


def _tree_bytes(tree, specs, mesh, dtype=None) -> int:
    total = 0
    for path, t in flatten_with_paths(tree).items():
        spec = spmd.spec_at(specs, path)
        total += math.prod(partition.local_shape(t.shape, spec, mesh)) * (
            torch.empty((), dtype=dtype or t.dtype).element_size())
    return total


def _seq_shard_cache(seq: int, tp: int, opt: bool) -> bool:
    return opt and tp > 1 and seq % tp == 0


def program(cfg: tr.ModelConfig, shape: str, mesh, opt: bool = False) -> tuple:
    """(``measure`` of position (0, 0)'s program of the cell, its memory
    record)."""
    seq, batch, kind = cfgs.SHAPES[shape]
    tp = mesh.shape["model"]
    lcfg = local_config(cfg, mesh)
    rows = _local_rows(batch, mesh)
    params = tree_map(lambda t: _meta(t.shape, BF16), tr.param_specs(lcfg))
    full = tr.param_specs(cfg)
    pspecs = partition.param_pspecs(cfg, full, mesh)
    param_bytes = _tree_bytes(full, pspecs, mesh, BF16)
    specs = cfgs.input_specs(cfg, shape)
    enc = ({"source_embed": _meta((rows, cfg.encoder.max_source, cfg.d_model), BF16)}
           if cfg.encoder is not None and kind != "decode" else {})

    if kind == "train":
        batch_local = dict({k: _meta((rows, seq), torch.int32)
                            for k in ("tokens", "labels")}, **enc)
        shard_specs = {p: _meta(partition.local_shape(t.shape, spmd.spec_at(pspecs, p), mesh),
                                BF16) for p, t in flatten_with_paths(full).items()}
        state = opt_mod.adamw_init(shard_specs)

        def run():
            steps.value_and_grad(lcfg, params, batch_local, compute_dtype=BF16)
            opt_mod.adamw_update(opt_mod.AdamWConfig(), shard_specs, state)

        opt_bytes = 3 * _tree_bytes(full, pspecs, mesh, torch.float32) + 4
        in_bytes = sum(_nbytes(t) for t in batch_local.values())
        mem = {"argument_bytes": param_bytes + opt_bytes + in_bytes,
               "output_bytes": param_bytes + opt_bytes + 12,
               "alias_bytes": param_bytes + opt_bytes}
    elif kind == "prefill":
        batch_local = dict({"tokens": _meta((rows, seq), torch.int32)}, **enc)
        cache = tr.init_cache(cfg, batch, seq, BF16, device=META)
        cache_bytes = _tree_bytes(cache, partition.cache_pspecs(cfg, cache, mesh,
                                                                stacked=False), mesh)

        def run():
            tr.prefill(lcfg, params, batch_local, max_seq=seq, compute_dtype=BF16)

        mem = {"argument_bytes": param_bytes + sum(_nbytes(t) for t in batch_local.values()),
               "output_bytes": batch * cfg.vocab * 2 + cache_bytes, "alias_bytes": 0}
    else:
        seq_shard = _seq_shard_cache(seq, tp, opt)
        cache_seq = seq // tp if seq_shard else seq
        cache = tr.init_cache(lcfg, rows, cache_seq, BF16, device=META)
        token = _meta((rows,), torch.int32)

        def run():
            tr.decode_step(lcfg, params, cache, token, seq - 1, compute_dtype=BF16)

        gcache = specs["cache"]
        cache_bytes = _tree_bytes(gcache, partition.cache_pspecs(
            cfg, gcache, mesh, stacked=False, seq_shard=opt), mesh)
        mem = {"argument_bytes": param_bytes + cache_bytes + rows * 4 + 4,
               "output_bytes": batch * cfg.vocab * 2 + cache_bytes,
               "alias_bytes": cache_bytes}
    got = measure(run)
    mem["temp_bytes"] = got["temp_bytes"]
    mem["peak_bytes_est"] = (mem["argument_bytes"] + mem["output_bytes"]
                             + mem["temp_bytes"] - mem["alias_bytes"])
    return got, mem


def lower_full(cfg, shape: str, mesh, opt: bool = False) -> dict:
    seq, batch, kind = cfgs.SHAPES[shape]
    t0 = time.time()
    got, mem = program(cfg, shape, mesh, opt)
    recs = spmd.program_collectives(cfg, mesh, kind, batch, seq,
                                    seq_shard=_seq_shard_cache(seq, mesh.shape["model"], opt))
    rec = dict(mem, flops=got["flops"], bytes=got["bytes"],
               collectives=ra.collective_bytes(recs),
               hbm_bytes_model=ra.hbm_bytes_from_ops(got["ops"], mem["argument_bytes"]),
               n_ops=len(got["ops"]), count_s=time.time() - t0)
    return rec


# ---------------------------------------------------------------------------
# GCN cells (the paper's own workload on the production mesh)
# ---------------------------------------------------------------------------


def lower_gcn(dataset: str, mesh) -> dict:
    """Position (0, 0)'s share of ``steps.make_gcn_step`` at the dataset's
    published sizes: its feature slice of each dense product, its data
    position's step range of each SpMM (the plain gather/scatter body) at
    full width, and the partial sums' collectives."""
    from repro_torch.graphs.synth import DATASET_STATS

    nodes, feats, classes, hidden, dens_a, _, _, _ = DATASET_STATS[dataset]
    nnz = max(nodes, int(dens_a * nodes * nodes)) + nodes
    k, r = 256, 64
    n_steps = int(nnz / k * 1.08) + 2
    tp, n_data = mesh.shape["model"], spmd.data_size(mesh)
    _, specs = steps.make_gcn_step(mesh, nodes, feats, hidden, classes, n_steps, k, r)
    x, w1, w2, val, lrow, lcol, win, _, row_map = specs
    per = val.shape[0] // n_data
    f32 = torch.float32

    def spmm(b):
        gcol = torch.clamp(_meta((per, k), torch.int64), max=nodes - 1)
        slot = (_meta((per, 1), torch.int64) * r + _meta((per, k), torch.int64)).reshape(-1)
        gathered = b[gcol.reshape(-1)] * _meta((per * k, 1), f32)
        out_perm = torch.zeros((row_map.shape[0], b.shape[1]), dtype=f32, device=META)
        out_perm.index_add_(0, slot, gathered)
        valid = _meta(row_map.shape, torch.bool)
        tgt = torch.where(valid, _meta(row_map.shape, torch.int64), 0)
        out = torch.zeros((nodes, b.shape[1]), dtype=f32, device=META)
        return out.index_add_(0, tgt, torch.where(valid[:, None], out_perm, 0))

    def run():
        h = torch.relu(spmm(_meta((nodes, x.shape[1] // tp), f32)
                            @ _meta((w1.shape[0] // tp, w1.shape[1]), f32)))
        spmm(h[:, :h.shape[1] // tp] @ _meta((w2.shape[0] // tp, classes), f32))

    t0 = time.time()
    got = measure(run)
    arg = (nodes * x.shape[1] // tp + w1.numel() // tp + w2.numel()) * 4 + per * k * 12 + (
        per * 8 + row_map.numel() * 4)
    recs = []
    for width in (w1.shape[1], classes):
        if tp > 1:
            recs.append({"kind": "all-reduce", "bytes": nodes * width * 4, "n": tp})
        if n_data > 1:
            recs.append({"kind": "all-reduce", "bytes": nodes * width * 4, "n": n_data})
    return {"argument_bytes": arg, "output_bytes": nodes * classes * 4, "alias_bytes": 0,
            "temp_bytes": got["temp_bytes"],
            "peak_bytes_est": arg + nodes * classes * 4 + got["temp_bytes"],
            "flops": got["flops"], "bytes": got["bytes"],
            "collectives": ra.collective_bytes(recs),
            "hbm_bytes_model": ra.hbm_bytes_from_ops(got["ops"], arg),
            "n_ops": len(got["ops"]), "n_steps": val.shape[0], "count_s": time.time() - t0}


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape: str, mesh_kind: str, force: bool = False,
             extrapolate: bool = True, variant: str = "base", *, cfg=None, mesh=None,
             out_dir: Path | None = None) -> dict:
    """One cell's record, written to ``out_dir`` (default ``RESULTS``).
    ``cfg`` and ``mesh`` replace the named arch's config and the production
    mesh (the tests' reduced cells); ``extrapolate`` is kept for the JAX
    package's command line: the ``*_extrap`` keys are the full counts."""
    del extrapolate
    out_dir = Path(out_dir or RESULTS)
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = "" if variant == "base" else f"__{variant}"
    out_path = out_dir / f"{arch}__{shape}__{mesh_kind}{suffix}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    opt = variant == "opt"
    mesh = mesh or make_production_mesh(multi_pod=(mesh_kind == "multi"))
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "chips": mesh.size,
           "status": "ok", "variant": variant, "device": "H100 SXM 80GB (roofline.HW)"}
    try:
        if arch.startswith("gcn-"):
            rec.update(lower_gcn(arch[4:], mesh))
        else:
            cfg = cfg or cfgs.get_config(arch)
            if opt:
                cfg = dataclasses.replace(cfg, attn_chunk=1024, moe_groups=16, sp_carry=True)
            ok, why = cfgs.cell_supported(cfg, shape)
            if not ok:
                rec.update({"status": "skipped", "reason": why})
                out_path.write_text(json.dumps(rec, indent=1))
                return rec
            rec.update(lower_full(cfg, shape, mesh, opt=opt))
            rec["n_params"] = tr.count_params(cfg)
            rec["n_active_params"] = tr.active_params(cfg)
        rec["flops_extrap"] = rec["flops"]
        rec["bytes_extrap"] = rec["bytes"]
        rec["hbm_extrap"] = rec["hbm_bytes_model"]
        rec["wire_extrap"] = rec["collectives"]["wire_bytes_total"]
        terms = ra.roofline_terms(rec["flops_extrap"], rec["bytes_extrap"],
                                  rec["wire_extrap"])
        terms["memory_v2_s"] = rec["hbm_extrap"] / ra.HW.hbm_bw
        terms["bound_v2_s"] = max(terms["compute_s"], terms["memory_v2_s"],
                                  terms["collective_s"])
        terms["roofline_fraction_v2"] = (terms["compute_s"] / terms["bound_v2_s"]
                                         if terms["bound_v2_s"] else 0.0)
        rec["roofline"] = terms
    except Exception as e:  # record failures — they are findings
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def summary_line(rec: dict, dt: float = 0.0) -> str:
    arch, shape, mk = rec["arch"], rec["shape"], rec["mesh"]
    if rec["status"] == "ok":
        r = rec["roofline"]
        mem = rec.get("peak_bytes_est", 0) / 1e9
        return (f"{arch:22s} {shape:12s} {mk:6s} ok mem={mem:8.2f}GB/dev "
                f"compute={r['compute_s']*1e3:9.2f}ms memory={r['memory_s']*1e3:9.2f}ms "
                f"coll={r['collective_s']*1e3:9.2f}ms dom={r['dominant']:10s} ({dt:.0f}s)")
    if rec["status"] == "skipped":
        return f"{arch:22s} {shape:12s} {mk:6s} SKIP ({rec['reason']})"
    return f"{arch:22s} {shape:12s} {mk:6s} ERROR {rec['error'][:120]}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--gcn", action="store_true", help="include GCN cells")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-extrap", action="store_true")
    ap.add_argument("--variant", default="base", choices=["base", "opt"])
    args = ap.parse_args(argv)

    archs = (cfgs.list_archs() if args.arch == "all" or args.all
             else args.arch.split(","))
    if args.gcn:
        archs = archs + [f"gcn-{d}" for d in cfgs.GCN_DATASETS]
    shapes = (list(cfgs.SHAPES) if args.shape == "all" or args.all
              else args.shape.split(","))
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    rows = []
    for arch in archs:
        for shape in shapes:
            if arch.startswith("gcn-") and shape != "train_4k":
                continue  # GCN cells are shape-free; run once
            for mk in meshes:
                t0 = time.time()
                rec = run_cell(arch, shape, mk, force=args.force,
                               extrapolate=not args.no_extrap, variant=args.variant)
                print(summary_line(rec, time.time() - t0), flush=True)
                rows.append(rec)
    n_ok = sum(r["status"] == "ok" for r in rows)
    n_skip = sum(r["status"] == "skipped" for r in rows)
    n_err = sum(r["status"] == "error" for r in rows)
    print(f"\n{n_ok} ok, {n_skip} skipped, {n_err} errors of {len(rows)} cells")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
