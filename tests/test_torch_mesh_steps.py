"""The step factories on a data × model mesh (``launch.steps`` with a
``Mesh``; ``sharding.spmd``), on ``["cpu"] * 8`` as 4 × 2.

The JAX package's own sharded steps fail on jax 0.9
(``tests/test_distributed.py``: its sharding constraints need Auto mesh
axes), so each sharded step is held against single-device oracles: the GCN
step against the JAX package's ``spmm_coo`` at that test's bound (1e-3) and
against the port's one-position step at 1e-5; the f32 train step's loss and
gradients against the single-device ``value_and_grad`` at
``test_torch_lm_train.py``'s tolerances (1e-5 of the loss, 1e-4 of each
leaf's largest entry); prefill and decode, with and without the
sequence-sharded cache, against the single-device ``prefill`` and
``decode_step`` at the LM tolerance, 2e-3·max(1, |gold|max). Repeated runs
are bit-equal, each position holds only its shard, and the collectives the
steps log are those ``spmd.program_collectives`` walks. A MoE model routes
the whole batch on the mesh as on one device: every layer's capacity
``keep`` mask and slot ids equal the single device's, drops included."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import spmm as jspmm  # noqa: E402
from repro.graphs import synth as jsynth  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.core import executor as texe  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.graphs import synth as tsynth  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_local_mesh  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.roofline import analysis as tra  # noqa: E402
from repro_torch.sharding import partition, spmd  # noqa: E402
from repro_torch.training import optimizer as opt_mod  # noqa: E402
from repro_torch.training.tree import flatten_with_paths, tree_map  # noqa: E402

LOSS_REL, GRAD_REL, LM_TOL = 1e-5, 1e-4, 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These programs are many small ops: one intra-op thread runs them
    several times faster than a pool that other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(model=2):
    return make_local_mesh(model_axis=model, devices=["cpu"] * 8)


# ---------------------------------------------------------------------------
# make_gcn_step
# ---------------------------------------------------------------------------


def _gcn_args(specs, ds, s):
    rng = np.random.default_rng(0)
    x = np.zeros(tuple(specs[0].shape), np.float32)
    x[:, :ds.num_features] = ds.features
    w1 = rng.standard_normal(tuple(specs[1].shape)).astype(np.float32)
    w2 = rng.standard_normal(tuple(specs[2].shape)).astype(np.float32)

    def padded(a, spec, dtype):
        out = np.zeros(tuple(spec.shape), dtype)
        out[tuple(slice(0, d) for d in a.shape)] = a
        return out

    val = padded(s.val.reshape(s.n_steps, -1), specs[3], np.float32)
    lrow = padded(s.local_row.reshape(s.n_steps, -1), specs[4], np.int32)
    lcol = padded(s.local_col.reshape(s.n_steps, -1), specs[5], np.int32)
    win = padded(s.win_id, specs[6], np.int32)
    cblk = padded(s.col_block, specs[7], np.int32)
    rmap = np.full(tuple(specs[8].shape), -1, np.int32)
    rmap[:s.row_map.shape[0]] = s.row_map
    return [torch.from_numpy(a) for a in (x, w1, w2, val, lrow, lcol, win, cblk, rmap)]


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernel_plan"])
def test_gcn_step_matches_spmm_coo_and_one_position(kernels, monkeypatch):
    """The reference script's cora at scale 8 (``tests/test_distributed.py``),
    its schedule with one column block, padded to the spec shapes; on the
    kernels' path (``_runs_kernels`` patched: each wrapper takes its plain
    version on the CPU) as on the card."""
    if kernels:
        monkeypatch.setattr(texe, "_runs_kernels", lambda dev: True)
    ds = tsynth.make_dataset("cora", scale=8, device="cpu")
    s = tsched.build_balanced_schedule(ds.adj, 32, 16)
    mesh = _mesh()
    fn, specs = steps.make_gcn_step(mesh, ds.num_nodes, ds.num_features, 16,
                                    ds.num_classes, s.n_steps, 32, 16)
    assert specs[3].shape[0] % 4 == 0 and specs[0].shape[1] % 2 == 0
    args = _gcn_args(specs, ds, s)
    out = fn(*args)
    assert out.shape == (ds.num_nodes, ds.num_classes)
    assert torch.equal(out, fn(*args))
    # the JAX package's single-device reference, as its test computes it
    jds = jsynth.make_dataset("cora", scale=8)
    x, w1, w2 = (a.numpy() for a in args[:3])
    ref_h = np.maximum(np.asarray(jspmm.spmm_coo(jds.adj, jnp.asarray(x @ w1))), 0)
    ref = np.asarray(jspmm.spmm_coo(jds.adj, jnp.asarray(ref_h @ w2)))
    assert np.abs(out.numpy() - ref).max() < 1e-3
    one, _ = steps.make_gcn_step(Mesh(["cpu"], (1, 1), ("data", "model")), ds.num_nodes,
                                 ds.num_features, 16, ds.num_classes, s.n_steps, 32, 16)
    single = one(*[a[:, :specs[1].shape[0]] if i == 0 else a for i, a in enumerate(args)])
    scale = max(1.0, float(single.abs().max()))
    assert float((out - single).abs().max()) <= 1e-5 * scale


def test_gcn_step_counts_one_spmm_per_data_position_and_layer(monkeypatch):
    """On the kernels' path each data position launches the window and the
    epilogue once a layer: 2 kernels × 4 data positions × 2 layers."""
    from repro_torch.kernels import spmm_cuda

    monkeypatch.setattr(texe, "_runs_kernels", lambda dev: True)
    calls = {"window": 0, "epilogue": 0}
    window, epilogue = spmm_cuda.spmm_window, spmm_cuda.spmm_epilogue

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(spmm_cuda, "spmm_window", count("window", window))
    monkeypatch.setattr(spmm_cuda, "spmm_epilogue", count("epilogue", epilogue))
    ds = tsynth.make_dataset("cora", scale=8, device="cpu")
    s = tsched.build_balanced_schedule(ds.adj, 32, 16)
    fn, specs = steps.make_gcn_step(_mesh(), ds.num_nodes, ds.num_features, 16,
                                    ds.num_classes, s.n_steps, 32, 16)
    fn(*_gcn_args(specs, ds, s))
    assert calls == {"window": 8, "epilogue": 8}


# ---------------------------------------------------------------------------
# the LM steps
# ---------------------------------------------------------------------------


def _lm(arch="qwen2-0.5b", b=8, s=16, seed=0, **replace):
    cfg = dataclasses.replace(tcfgs.get_reduced_config(arch), **replace)
    params = tr.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    rng = np.random.default_rng(seed)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)), dtype=torch.int32)
             for k in ("tokens", "labels")}
    return cfg, params, batch


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("model", [1, 2, 4])
def test_sharded_loss_and_grads_match_one_device(model, remat):
    cfg, params, batch = _lm(remat=remat)
    loss, grads = steps.value_and_grad(cfg, params, batch, compute_dtype=torch.float32)
    mloss, mgrads = steps.mesh_value_and_grad(cfg, _mesh(model), params, batch,
                                              compute_dtype=torch.float32)
    assert abs(float(mloss) - float(loss)) <= LOSS_REL * abs(float(loss))
    got = flatten_with_paths(spmd.unshard_tree(mgrads, "cpu"))
    for key, want in flatten_with_paths(grads).items():
        tol = GRAD_REL * float(want.abs().max())
        assert float((got[key] - want).abs().max()) <= tol, key


def test_sharded_train_step_learns_is_bit_equal_and_holds_only_shards():
    """The reference test's run (bf16 working weights, 6 steps of the
    default AdamW): the loss falls; a second run from the same state gives
    the same bits; every position holds only its block of every leaf."""
    cfg, master, batch = _lm()
    mesh = _mesh()
    specs = {k: torch.empty((8, 16), dtype=torch.int32, device="meta") for k in batch}
    step, (pspecs, ospecs) = steps.make_train_step(cfg, mesh, specs)

    def run():
        params = tree_map(lambda t: t.to(torch.bfloat16), master)
        opt = opt_mod.adamw_init(master)
        losses = []
        for _ in range(6):
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"]))
        return params, opt, losses

    p1, o1, l1 = run()
    assert l1[-1] < l1[0], l1
    p2, o2, l2 = run()
    assert l1 == l2
    for a, b in zip(flatten_with_paths((p1, o1)).values(), flatten_with_paths((p2, o2)).values()):
        assert torch.equal(partition.unshard(a, "cpu"), partition.unshard(b, "cpu"))
    want = partition.param_pspecs(cfg, pspecs, mesh)
    for path, sh in flatten_with_paths(p1).items():
        assert sh.spec == spmd.spec_at(want, path)
        assert sh.dtype == torch.bfloat16
        for pos in mesh.positions():
            assert tuple(sh.local(pos).shape) == partition.local_shape(sh.shape, sh.spec, mesh)
    for path, sh in flatten_with_paths(o1["m"]).items():
        assert sh.spec == spmd.spec_at(want, path)
        for pos in mesh.positions():
            assert tuple(sh.local(pos).shape) == sh.local_shape
    assert int(partition.unshard(o1["count"], "cpu")) == 6


def test_sharded_train_step_matches_one_device_step():
    """One f32 step on the mesh (``mesh_value_and_grad``, then
    ``mesh_adamw_update``) against the single-device step
    (``value_and_grad``, then ``adamw_update``): the grad norm and the lr;
    the moments m and v within 1e-4 of each leaf's largest entry; and the
    master's (and so the f32 parameters') change within 1e-6 wherever |g|
    is above 1 % of its leaf's largest, where AdamW's first step is ±lr
    whatever the gradient's size and its sign cannot flip."""
    cfg, params, batch = _lm()
    f32 = torch.float32
    opt_cfg = opt_mod.AdamWConfig(lr=1e-2, warmup_steps=1)
    grads = steps.value_and_grad(cfg, params, batch, compute_dtype=f32)[1]
    _, want_o, want_m = opt_mod.adamw_update(opt_cfg, grads, opt_mod.adamw_init(params),
                                             param_dtype=f32)
    mesh = _mesh()
    _, mgrads = steps.mesh_value_and_grad(cfg, mesh, params, batch, compute_dtype=f32)
    pspecs = partition.param_pspecs(cfg, params, mesh)
    got_p, got_o, got_m = steps.mesh_adamw_update(
        opt_cfg, spmd.shard_tree(params, pspecs, mesh), mgrads,
        spmd.shard_tree(opt_mod.adamw_init(params), partition.opt_state_pspecs(pspecs), mesh))
    gnorm = float(want_m["grad_norm"])
    assert abs(float(got_m["grad_norm"]) - gnorm) <= 1e-5 * gnorm
    assert float(got_m["lr"]) == float(want_m["lr"])
    assert int(partition.unshard(got_o["count"], "cpu")) == 1
    got = {k: flatten_with_paths(spmd.unshard_tree(got_o[k], "cpu"))
           for k in ("master", "m", "v")}
    got_p = flatten_with_paths(spmd.unshard_tree(got_p, "cpu"))
    old, g = flatten_with_paths(params), flatten_with_paths(grads)
    for key, master in flatten_with_paths(want_o["master"]).items():
        for k in ("m", "v"):
            w = flatten_with_paths(want_o[k])[key]
            assert float((got[k][key] - w).abs().max()) <= 1e-4 * float(w.abs().max()), (
                k, key)
        assert got_p[key].dtype == f32 and torch.equal(got_p[key], got["master"][key])
        sure = g[key].abs() > 0.01 * float(g[key].abs().max())
        assert int(sure.sum()) > 0, key
        moved = (got["master"][key] - old[key])[sure]
        assert float((moved - (master - old[key])[sure]).abs().max()) <= 1e-6, key


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "starcoder2-3b", "recurrentgemma-2b",
                                  "rwkv6-3b", "whisper-tiny"])
def test_prefill_and_decode_match_one_device(arch, seq_shard):
    cfg, params, batch = _lm(arch, b=8, s=12)
    f32, max_seq = torch.float32, 24
    inputs = {"tokens": batch["tokens"]}
    if cfg.encoder is not None:
        inputs["source_embed"] = torch.randn(8, cfg.encoder.max_source, cfg.d_model,
                                             generator=torch.Generator().manual_seed(1))
    mesh = _mesh()
    gold, cache1 = tr.prefill(cfg, params, inputs, max_seq, compute_dtype=f32)
    logits, cache2 = spmd.prefill(cfg, mesh, params, inputs, max_seq, compute_dtype=f32)
    assert float((logits - gold).abs().max()) <= LM_TOL * max(1.0, float(gold.abs().max()))
    for c_sh in cache2:
        for sh in c_sh.values():
            for pos in mesh.positions():
                assert tuple(sh.local(pos).shape) == sh.local_shape
    if seq_shard:  # the prefill's cache, resharded by sequence on the way in
        cache2 = spmd.unshard_tree(cache2, "cpu")
    rng = np.random.default_rng(3)
    for i in range(4):
        token = torch.as_tensor(rng.integers(0, cfg.vocab, (8,)), dtype=torch.int32)
        gold, cache1 = tr.decode_step(cfg, params, cache1, token, 12 + i, compute_dtype=f32)
        logits, cache2 = spmd.decode_step(cfg, mesh, params, cache2, token, 12 + i,
                                          seq_shard, compute_dtype=f32)
        assert float((logits - gold).abs().max()) <= LM_TOL * max(
            1.0, float(gold.abs().max())), i
    if seq_shard:  # every attention cache's sequence over model
        assert all(c["k"].spec[1] == "model" for c in cache2 if "k" in c)


def test_mesh_prefill_and_decode_steps_run_spmd_in_bf16():
    """The factories on a mesh are ``spmd.prefill``/``spmd.decode_step`` in
    bf16, bit for bit, and keep the last call's log."""
    cfg, params, batch = _lm(b=8, s=12)
    mesh, max_seq, bf16 = _mesh(), 16, torch.bfloat16
    params = tree_map(lambda t: t.to(bf16), params)
    prefill, _ = steps.make_prefill_step(cfg, mesh, None, max_seq)
    decode, _ = steps.make_decode_step(cfg, mesh, 8, max_seq)
    logits, cache = prefill(params, {"tokens": batch["tokens"]})
    want, want_cache = spmd.prefill(cfg, mesh, params, {"tokens": batch["tokens"]}, max_seq)
    assert logits.dtype == bf16 and torch.equal(logits, want)
    assert prefill.log and all(r["bytes"] > 0 for r in prefill.log)
    token = batch["tokens"][:, 0]
    logits, _ = decode(params, cache, token, 12)
    want, _ = spmd.decode_step(cfg, mesh, params, want_cache, token, 12)
    assert torch.equal(logits, want) and decode.log


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-2b", "whisper-tiny",
                                  "granite-moe-3b-a800m"])
def test_prefill_and_decode_log_what_the_walk_counts(arch):
    """The collectives the steps log at position (0, 0) are those
    ``program_collectives`` walks for a prompt that fills the cache and a
    decode at its last position (the dry-run's cells)."""
    max_seq = 16
    cfg, params, batch = _lm(arch, b=8, s=max_seq)
    mesh = _mesh()
    inputs = {"tokens": batch["tokens"]}
    if cfg.encoder is not None:
        inputs["source_embed"] = torch.zeros(8, cfg.encoder.max_source, cfg.d_model)
    f32 = torch.float32
    for seq_shard in (False, True):
        log = []
        _, cache = spmd.prefill(cfg, mesh, params, inputs, max_seq, compute_dtype=f32,
                                log=log)
        want = spmd.program_collectives(cfg, mesh, "prefill", 8, max_seq,
                                        compute_dtype=f32, param_dtype=f32)
        assert tra.collective_bytes(log) == tra.collective_bytes(want)
        log = []
        spmd.decode_step(cfg, mesh, params, spmd.unshard_tree(cache, "cpu"),
                         batch["tokens"][:, 0], max_seq - 1, seq_shard, compute_dtype=f32,
                         log=log)
        want = spmd.program_collectives(cfg, mesh, "decode", 8, max_seq, seq_shard=seq_shard,
                                        compute_dtype=f32, param_dtype=f32)
        assert tra.collective_bytes(log) == tra.collective_bytes(want)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-2b", "whisper-tiny",
                                  "granite-moe-3b-a800m"])
def test_train_step_logs_what_the_walk_counts(arch, remat):
    """The training walk — the dry-run's wire bytes for a train cell —
    against what ``mesh_value_and_grad`` logs: the gathers, each partial
    sum in the forward, remat's recompute and the backward, and the
    gradients' reductions over the data positions."""
    cfg, params, batch = _lm(arch, remat=remat)
    if cfg.encoder is not None:
        batch["source_embed"] = torch.zeros(8, cfg.encoder.max_source, cfg.d_model)
    mesh, f32 = _mesh(), torch.float32
    log = []
    steps.mesh_value_and_grad(cfg, mesh, params, batch, compute_dtype=f32, log=log)
    want = spmd.program_collectives(cfg, mesh, "train", 8, 16, compute_dtype=f32,
                                    param_dtype=f32)
    got = tra.collective_bytes(log)
    assert got == tra.collective_bytes(want)
    assert got.get("reduce-scatter_count", 0) + got.get("all-reduce_count", 0) > 0


# ---------------------------------------------------------------------------
# MoE over the global batch
# ---------------------------------------------------------------------------


@pytest.fixture
def routes(monkeypatch):
    """Every ``moe.route`` call's ``Routing``, in call order."""
    calls = []
    route = moe_mod.route

    def recorded(*a, **k):
        calls.append(route(*a, **k))
        return calls[-1]

    monkeypatch.setattr(moe_mod, "route", recorded)
    return calls


def _moe_mesh(shape):
    data, model = shape
    return make_local_mesh(model_axis=model, devices=["cpu"] * (data * model))


def _same_routing(mesh_calls, one, n_data):
    """The mesh's routings, position-major (each data position routes
    every layer), joined per layer in data order: ``keep`` and ``slot``
    equal to the single device's routing of that layer."""
    n_layers = len(one)
    assert len(mesh_calls) == n_data * n_layers
    for i, want in enumerate(one):
        parts = [mesh_calls[d * n_layers + i] for d in range(n_data)]
        for name in ("keep", "slot", "pos"):
            got = torch.cat([getattr(r, name) for r in parts], dim=-1)
            assert np.array_equal(got.numpy(), getattr(want, name).numpy()), (i, name)
        assert all(r.capacity == want.capacity for r in parts)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("shape", [(2, 2), (4, 2)], ids=["2x2", "4x2"])
def test_moe_train_step_routes_the_global_batch(shape, remat, routes):
    """Reduced granite-moe, f32: capacity drops tokens on one device, and
    the mesh drops the same ones (the routing pass and the differentiated
    pass alike); the loss, aux included, and the gradients match the
    single device's."""
    cfg, params, batch = _lm("granite-moe-3b-a800m", remat=remat)
    f32 = torch.float32
    loss, grads = steps.value_and_grad(cfg, params, batch, compute_dtype=f32)
    n_layers = len(tr.layer_kinds(cfg))
    one = list(routes[:n_layers])
    assert sum(int((~r.keep).sum()) for r in one) > 0  # capacity drops on one device
    routes.clear()
    mloss, mgrads = steps.mesh_value_and_grad(cfg, _moe_mesh(shape), params, batch,
                                              compute_dtype=f32)
    assert abs(float(mloss) - float(loss)) <= LOSS_REL * abs(float(loss))
    got = flatten_with_paths(spmd.unshard_tree(mgrads, "cpu"))
    for key, want in flatten_with_paths(grads).items():
        tol = GRAD_REL * float(want.abs().max())
        assert float((got[key] - want).abs().max()) <= tol, key
    n_data = shape[0]
    _same_routing(routes[:n_data * n_layers], one, n_data)          # the routing pass
    # the differentiated pass: each position's forward (then remat's recompute)
    per_pos = n_layers * (2 if remat else 1)
    assert len(routes) == n_data * (n_layers + per_pos)
    diff = routes[n_data * n_layers:]
    _same_routing([diff[d * per_pos + i] for d in range(n_data) for i in range(n_layers)],
                  one, n_data)


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)], ids=["2x2", "4x2"])
def test_moe_prefill_and_decode_route_the_global_batch(shape, routes):
    """``spmd.prefill`` of reduced granite-moe routes as the single
    device's prefill (the same drops) and its logits match; decode stays
    dropless and matches too."""
    cfg, params, batch = _lm("granite-moe-3b-a800m", b=8, s=12)
    f32, max_seq, mesh = torch.float32, 16, _moe_mesh(shape)
    inputs = {"tokens": batch["tokens"]}
    gold, cache1 = tr.prefill(cfg, params, inputs, max_seq, compute_dtype=f32)
    one = list(routes)
    assert sum(int((~r.keep).sum()) for r in one) > 0
    routes.clear()
    logits, cache2 = spmd.prefill(cfg, mesh, params, inputs, max_seq, compute_dtype=f32)
    assert float((logits - gold).abs().max()) <= LM_TOL * max(1.0, float(gold.abs().max()))
    _same_routing(list(routes), one, shape[0])
    rng = np.random.default_rng(3)
    for i in range(2):
        routes.clear()
        token = torch.as_tensor(rng.integers(0, cfg.vocab, (8,)), dtype=torch.int32)
        gold, cache1 = tr.decode_step(cfg, params, cache1, token, 12 + i, compute_dtype=f32)
        one = list(routes)
        routes.clear()
        logits, cache2 = spmd.decode_step(cfg, mesh, params, cache2, token, 12 + i,
                                          compute_dtype=f32)
        _same_routing(list(routes), one, shape[0])
        assert all(bool(r.keep.all()) for r in routes)
        assert float((logits - gold).abs().max()) <= LM_TOL * max(
            1.0, float(gold.abs().max())), i


def test_a_device_is_the_one_device_step():
    cfg, params, batch = _lm()
    step, _ = steps.make_train_step(cfg, "cpu")
    opt = opt_mod.adamw_init(params)
    p, _, m = step(tree_map(lambda t: t.to(torch.bfloat16), params), opt, batch)
    assert all(isinstance(t, torch.Tensor) for t in flatten_with_paths(p).values())


def test_launch_train_on_a_mesh_learns(tmp_path):
    losses = ttrain.main(["--arch", "qwen2-0.5b", "--reduced", "--steps", "8", "--batch",
                          "4", "--seq", "16", "--lr", "2e-3", "--device", "cpu",
                          "--model-axis", "2", "--log-every", "100",
                          "--ckpt-dir", str(tmp_path), "--ckpt-every", "4"])
    assert len(losses) == 8 and losses[-1] < losses[0]
    again = ttrain.main(["--arch", "qwen2-0.5b", "--reduced", "--steps", "10", "--batch",
                         "4", "--seq", "16", "--lr", "2e-3", "--device", "cpu",
                         "--model-axis", "2", "--log-every", "100",
                         "--ckpt-dir", str(tmp_path), "--ckpt-every", "4"])
    assert len(again) == 2  # resumed from step 8
