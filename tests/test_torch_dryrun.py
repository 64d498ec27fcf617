"""``repro_torch.launch.dryrun`` on reduced configs and a small meta mesh:
argument bytes against what the JAX package's specs give for the same
shapes, forward FLOPs of qwen2 against 2·N·tokens plus the attention term,
the skip rule, a GCN cell, and the wire bytes against the sharded step's
own walk."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.sharding import partition as jpart  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.roofline import analysis as tra  # noqa: E402
from repro_torch.sharding import spmd  # noqa: E402
from repro_torch.training.tree import tree_map  # noqa: E402

META_MESH = Mesh(["meta"] * 8, (4, 2), ("data", "model"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These programs are many small ops: one intra-op thread runs them
    several times faster than a pool that other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_local_bytes(tree, specs, mesh, elt):
    """Per-device bytes of ``tree`` under the JAX package's ``specs``."""
    flat = jax.tree_util.tree_leaves(tree)
    flat_s = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    total = 0
    for leaf, spec in zip(flat, flat_s):
        shape = list(leaf.shape)
        for i, entry in enumerate(tuple(spec)):
            for axis in (() if entry is None else (entry if isinstance(entry, tuple)
                                                   else (entry,))):
                shape[i] //= mesh.shape[axis]
        total += int(np.prod(shape)) * elt
    return total


def test_train_cell_argument_bytes_equal_the_reference_specs(tmp_path):
    arch = "qwen2-0.5b"
    jcfg, tcfg = jcfgs.get_reduced_config(arch), tcfgs.get_reduced_config(arch)
    rec = dryrun.run_cell(arch, "train_4k", "small", force=True, cfg=tcfg,
                          mesh=META_MESH, out_dir=tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    jmesh = AbstractMesh((4, 2), ("data", "model"))
    specs = jtr.param_specs(jcfg)
    pspecs = jpart.param_pspecs(jcfg, specs, jmesh)
    params = _jax_local_bytes(specs, pspecs, jmesh, 2)          # bf16 working
    opt = 3 * _jax_local_bytes(specs, pspecs, jmesh, 4) + 4      # f32 master, m, v; count
    seq, batch, _ = tcfgs.SHAPES["train_4k"]
    tokens = 2 * (batch // 4) * seq * 4                          # tokens, labels per row
    assert rec["argument_bytes"] == params + opt + tokens
    assert rec["alias_bytes"] == params + opt
    assert rec["flops"] > 0 and rec["temp_bytes"] > 0
    assert rec["roofline"]["compute_s"] == rec["flops"] / tra.HW.peak_flops_bf16
    assert rec["flops_extrap"] == rec["flops"] and rec["wire_extrap"] == (
        rec["collectives"]["wire_bytes_total"])
    # the wire bytes are the sharded step's walk of its gathers and sums
    want = tra.collective_bytes(spmd.program_collectives(tcfg, META_MESH, "train", batch,
                                                         seq))
    assert rec["collectives"] == want
    assert json.loads((tmp_path / "qwen2-0.5b__train_4k__small.json").read_text()) == rec


def test_qwen2_forward_flops_are_2_n_tokens_plus_attention():
    cfg = tcfgs.get_reduced_config("qwen2-0.5b")
    b, s = 2, 64
    params = tree_map(lambda t: torch.empty(t.shape, dtype=torch.bfloat16, device="meta"),
                      ttr.param_specs(cfg))
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32, device="meta")}
    got = dryrun.measure(lambda: ttr.model_forward(cfg, params, batch))
    n = ttr.count_params(cfg)
    # the flash kernel's causal work: s(s + 1)/2 visible pairs a head
    attention = 4 * b * cfg.n_heads * (s * (s + 1) // 2) * cfg.head_dim * cfg.n_layers
    want = 2 * n * b * s + attention
    assert abs(got["flops"] - want) <= 0.02 * want


@pytest.mark.parametrize("causal, window", [(True, None), (False, None), (True, 24)])
def test_attention_on_meta_counts_the_flash_kernel(causal, window):
    """On the meta device the attention is the flash kernel's operator: 4·D
    FLOPs a visible pair and head, q, k, v read and the output written
    once, no S × S temporary; in training the backward's ``attention_vjp``
    adds its own ops."""
    from repro_torch.kernels import flash_attention_cuda as tfa
    from repro_torch.kernels import ops

    b, sq, sk, h, hkv, d = 2, 48, 64, 4, 2, 32
    q = torch.empty((b, sq, h, d), dtype=torch.bfloat16, device="meta")
    k = torch.empty((b, sk, hkv, d), dtype=torch.bfloat16, device="meta")
    got = dryrun.measure(lambda: ops.attention(q, k, k, causal=causal, window=window))
    pairs = tfa.visible_pairs(sq, sk, causal, window)
    assert pairs == sum(1 for i in range(sq) for j in range(sk)
                        if (not causal or j <= i + sk - sq)
                        and (window is None or j > i + sk - sq - window))
    assert got["flops"] == 4 * b * h * d * pairs
    assert [o["op"] for o in got["ops"]] == ["flash_attention"]
    io = 2 * (2 * q.numel() + 2 * k.numel())
    assert got["ops"][0]["in_bytes"] + got["ops"][0]["out_bytes"] == io
    assert tra.hbm_bytes_from_ops(got["ops"]) == io
    assert got["temp_bytes"] == 2 * q.numel()
    qg = q.detach().requires_grad_(True)
    train = dryrun.measure(lambda: torch.autograd.grad(
        ops.attention(qg, k, k, causal=causal, window=window).sum(), qg))
    assert train["flops"] > got["flops"] and "flash_attention" in [
        o["op"] for o in train["ops"]]


def test_local_config_splits_what_the_step_splits():
    cfg = tcfgs.get_config("qwen2-0.5b")  # 14 heads on 2 KV heads, d_ff 4864
    two = Mesh(["meta"] * 4, (2, 2), ("data", "model"))
    local = dryrun.local_config(cfg, two)
    assert (local.n_heads, local.n_kv_heads, local.d_ff) == (7, 1, 2432)
    assert local.head_dim == cfg.head_dim
    wide = dryrun.local_config(cfg, Mesh(["meta"] * 256, (16, 16), ("data", "model")))
    assert (wide.n_heads, wide.n_kv_heads, wide.d_ff) == (14, 2, 304)  # heads do not split
    rwkv = tcfgs.get_config("rwkv6-3b")
    assert dryrun.local_config(rwkv, two).d_ff == rwkv.d_ff  # channel mix runs whole


def test_long_context_cell_on_a_quadratic_arch_is_skipped(tmp_path):
    rec = dryrun.run_cell("qwen2-0.5b", "long_500k", "small", force=True,
                          cfg=tcfgs.get_reduced_config("qwen2-0.5b"), mesh=META_MESH,
                          out_dir=tmp_path)
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]
    assert "roofline" not in rec


def test_decode_cell_with_the_seq_sharded_cache(tmp_path):
    cfg = tcfgs.get_reduced_config("starcoder2-3b")
    for variant in ("base", "opt"):
        rec = dryrun.run_cell("starcoder2-3b", "decode_32k", "small", force=True,
                              variant=variant, cfg=cfg, mesh=META_MESH, out_dir=tmp_path)
        assert rec["status"] == "ok", rec.get("error")
        assert rec["alias_bytes"] > 0 and rec["collectives"]["wire_bytes_total"] > 0


def test_gcn_cell(tmp_path):
    rec = dryrun.run_cell("gcn-cora", "train_4k", "small", force=True, mesh=META_MESH,
                          out_dir=tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    nodes, feats, classes, hidden = 2708, 1433, 7, 16
    feats_p = -(-feats // 2) * 2
    want = 2 * nodes * (feats_p // 2) * hidden + 2 * nodes * (hidden // 2) * classes
    assert rec["flops"] == want
    assert rec["collectives"]["all-reduce_count"] == 4
    assert rec["n_steps"] % 4 == 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
