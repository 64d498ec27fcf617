"""Parity of the port's MoE (``core/moe_balance``, ``models/moe``) with the
JAX package: the placement balancer array for array (``np.array_equal``) on
a grid of expert, device and spare-slot counts; the reference's own
balancer and layer tests re-run on the port; ``moe_forward`` and its aux
loss within 1e-5 of the reference (``tests/test_moe.py``'s tolerance) on the
same weights and numpy inputs — dropless, with tokens dropped by capacity,
with a capacity override, in dispatch groups, under AWB placements with
spare slots, and under the identity placement with more slots than experts
(the reference's gather clamps past the last expert); ``route``'s ranks
equal to a loop recomputation; and a JAX-package checkpoint of reduced
granite-moe served through the port's CLI."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfgs  # noqa: E402
from repro.core import moe_balance as jbal  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.transformer_serve import ServeEngine as JaxEngine  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro_torch.core import moe_balance as tbal  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

ATOL = 1e-5

# (n_experts, n_devices, spare slots a device, zipf seed)
GRID = [(8, 2, 0, 0), (8, 8, 3, 1), (13, 4, 1, 2), (16, 4, 2, 3), (40, 4, 2, 4),
        (40, 8, 0, 5), (64, 2, 3, 6), (64, 8, 1, 7), (33, 5, 3, 8), (20, 3, 0, 9)]


def _placements_equal(a, b):
    assert np.array_equal(a.slots, b.slots)
    assert np.array_equal(a.replica_count, b.replica_count)
    assert np.array_equal(a.replica_rank, b.replica_rank)
    assert a.slots.dtype == b.slots.dtype


# ---- the placement balancer -------------------------------------------------

@pytest.mark.parametrize("e,d,spare,seed", GRID)
def test_balancer_matches_reference(e, d, spare, seed):
    load = tbal.zipf_expert_load(e, 10000, alpha=1.1, seed=seed)
    assert np.array_equal(load, jbal.zipf_expert_load(e, 10000, alpha=1.1, seed=seed))
    spd = -(-e // d) + spare
    for tp, jp in ((tbal.static_placement(e, d), jbal.static_placement(e, d)),
                   (tbal.balance_placement(load, d, slots_per_device=spd),
                    jbal.balance_placement(load, d, slots_per_device=spd)),
                   (tbal.balance_placement(load, d), jbal.balance_placement(load, d))):
        _placements_equal(tp, jp)
        loads = tbal.device_loads(tp, load)
        assert np.array_equal(loads, jbal.device_loads(jp, load))
        assert tbal.imbalance(loads) == jbal.imbalance(loads)
        assign = np.random.default_rng(seed).integers(0, e, 300)
        for a, b in zip(tbal.dispatch_plan(assign, tp), jbal.dispatch_plan(assign, jp)):
            assert np.array_equal(a, b)
        tables = tmoe.tables_from_placement(tp, device="cpu")
        for got, want in zip(tables, jmoe.tables_from_placement(jp)):
            assert got.dtype == torch.int64
            assert np.array_equal(got.numpy(), np.asarray(want))


def test_balancer_raises_without_a_slot_per_expert():
    with pytest.raises(ValueError, match="not enough slots"):
        tbal.balance_placement(np.ones(9), 2, slots_per_device=4)


def test_replication_fixes_evil_expert():
    load = np.ones(16)
    load[3] = 100.0  # evil expert
    static = tbal.imbalance(tbal.device_loads(tbal.static_placement(16, 4), load))
    bal = tbal.balance_placement(load, 4, slots_per_device=8)
    awb = tbal.imbalance(tbal.device_loads(bal, load))
    assert bal.replica_count[3] > 1
    assert awb < static / 2


def test_dispatch_plan_round_robins():
    load = np.array([100.0, 1, 1, 1])
    p = tbal.balance_placement(load, 2, slots_per_device=3)
    assign = np.zeros(10, np.int64)  # 10 tokens to the hot expert
    dev, slot = tbal.dispatch_plan(assign, p)
    r = int(p.replica_count[0])
    assert r > 1
    assert len(set(map(tuple, zip(dev, slot)))) == r  # spread over replicas


def test_identity_placement_matches_reference():
    dims = tmoe.MoEDims(16, 8, 4, 2, n_slots=6)
    for got, want in zip(tmoe.identity_placement(dims, device="cpu"),
                         jmoe.identity_placement(jmoe.MoEDims(*dims))):
        assert np.array_equal(got.numpy(), np.asarray(want))


# ---- the MoE layer ----------------------------------------------------------

def _dims(**kw):
    d = dict(d_model=16, d_ff=8, n_experts=4, top_k=2,
             capacity_factor=64.0, activation="silu", glu=True, n_slots=0)
    d.update(kw)
    return tmoe.MoEDims(**d)


def _layer(dims, seed=0, b=2, s=10):
    """The reference's parameters (JAX arrays: their gather clamps, numpy's
    would raise), the port's copies and a numpy input."""
    jp = jmoe.init_moe_params(jax.random.PRNGKey(seed), jmoe.MoEDims(*dims))
    x = np.random.default_rng(seed + 10).standard_normal((b, s, dims.d_model)).astype(
        np.float32)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}, x


def _forward_both(dims, jp, tp, x, jplacement=None, tplacement=None, **kw):
    jo, ja = jmoe.moe_forward(jp, jmoe.MoEDims(*dims), jnp.asarray(x),
                              placement=jplacement, **kw)
    to, ta = tmoe.moe_forward(tp, dims, torch.from_numpy(x), placement=tplacement, **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(ta), float(ja), atol=ATOL, rtol=0)
    return to


@pytest.mark.parametrize("case,seed", [
    (dict(), 0),                                    # dropless: capacity factor 64
    (dict(capacity_factor=1.25), 1),
    (dict(capacity_factor=0.01), 0),                # one row a slot
    (dict(capacity_factor=1.25, n_experts=8, top_k=3, d_ff=12, activation="gelu"), 0),
    (dict(glu=False, activation="relu", capacity_factor=0.8), 0),
    (dict(n_groups=4), 0),                          # 4 divides 2 x 10 tokens
    (dict(n_groups=3), 0),                          # it does not: one group
    (dict(n_groups=4, capacity_factor=0.5), 0),
], ids=lambda c: (",".join(f"{k}={v}" for k, v in c.items()) or "dropless")
    if isinstance(c, dict) else f"seed{c}")
def test_moe_forward_matches_reference(case, seed):
    dims = _dims(**case)
    jp, tp, x = _layer(dims, seed=seed)
    _forward_both(dims, jp, tp, x)
    r = tmoe.route(tp, dims, torch.from_numpy(x))
    # at these capacity factors tokens really drop; at 64 none does
    assert bool(r.keep.all()) == (dims.capacity_factor == 64.0)
    want_groups = dims.n_groups if 20 % dims.n_groups == 0 else 1
    assert r.slot.shape == (want_groups, 20 // want_groups * dims.top_k)


@pytest.mark.parametrize("override", [1, 3, 40])
def test_capacity_override_matches_reference(override):
    dims = _dims(capacity_factor=1.25, n_experts=6, top_k=2)
    jp, tp, x = _layer(dims, seed=3)
    _forward_both(dims, jp, tp, x, capacity_override=override)
    r = tmoe.route(tp, dims, torch.from_numpy(x), capacity_override=override)
    assert r.capacity == override
    assert bool(r.keep.all()) == (override >= 40)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cf", [64.0, 1.0])
def test_awb_placement_matches_reference(seed, cf):
    """Balanced placements with spare slots (n_slots > E, hot experts
    replicated), dropless and with drops."""
    dims = _dims(n_slots=6, capacity_factor=cf)
    jp, tp, x = _layer(dims, seed=seed)
    load = tbal.zipf_expert_load(4, 1000, alpha=1.0, seed=seed)
    placement = tbal.balance_placement(load, 2, slots_per_device=3)
    assert placement.replica_count.max() > 1
    _forward_both(dims, jp, tp, x, jmoe.tables_from_placement(placement),
                  tmoe.tables_from_placement(placement, device="cpu"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moe_output_invariant_to_placement(seed):
    """Replicas compute identical experts — any AWB placement must produce
    the same output when dropless (the evil-expert adder tree is exact)."""
    dims = _dims(n_slots=6)
    _, tp, x = _layer(dims, seed=seed)
    xt = torch.from_numpy(x)
    base, _ = tmoe.moe_forward(tp, dims, xt)
    load = tbal.zipf_expert_load(4, 1000, alpha=1.0, seed=seed)
    tables = tmoe.tables_from_placement(
        tbal.balance_placement(load, 2, slots_per_device=3), device="cpu")
    got, _ = tmoe.moe_forward(tp, dims, xt, placement=tables)
    np.testing.assert_allclose(got.numpy(), base.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("cf", [64.0, 0.3])
def test_identity_placement_past_the_last_expert(cf):
    """``n_slots`` 6 over 4 experts with ``placement=None``: the reference
    gathers ``w[arange(6)]``, which JAX clamps to the last expert."""
    dims = _dims(n_slots=6, capacity_factor=cf)
    jp, tp, x = _layer(dims, seed=5)
    got = _forward_both(dims, jp, tp, x)
    tables = tmoe.identity_placement(dims, device="cpu")
    again, _ = tmoe.moe_forward(tp, dims, torch.from_numpy(x), placement=tables)
    assert torch.equal(got, again)


def test_moe_matches_dense_reference():
    """Dropless MoE equals routing every token densely to its top-k."""
    dims = _dims()
    _, tp, x = _layer(dims, s=8)
    xt = torch.from_numpy(x).reshape(-1, dims.d_model)
    probs = torch.softmax(xt @ tp["router"], -1)
    w, ids = torch.topk(probs, dims.top_k)
    w = w / w.sum(-1, keepdim=True)
    dense = torch.stack([(torch.nn.functional.silu(xt @ tp["w_gate"][e]) * (xt @ tp["w_in"][e]))
                         @ tp["w_out"][e] for e in range(dims.n_experts)], 1)
    ref = (torch.gather(dense, 1, ids[..., None].expand(-1, -1, dims.d_model))
           * w[..., None]).sum(1)
    out, aux = tmoe.moe_forward(tp, dims, torch.from_numpy(x))
    np.testing.assert_allclose(out.reshape(-1, dims.d_model).numpy(), ref.numpy(),
                               atol=ATOL, rtol=0)
    assert float(aux) > 0


def test_capacity_drops_passthrough():
    """Tokens over capacity contribute nothing (residual passthrough)."""
    dims = _dims(capacity_factor=0.01)  # cap = 1 slot per expert
    _, tp, x = _layer(dims, b=1, s=16)
    out, _ = tmoe.moe_forward(tp, dims, torch.from_numpy(x))
    full, _ = tmoe.moe_forward(tp, dims, torch.from_numpy(x), capacity_override=64)
    assert float(out.abs().sum()) < float(full.abs().sum())


def _loop_ranks(ids):
    """Arrival rank of each element within its bucket, per group: a loop."""
    out = np.zeros_like(ids)
    for gi in range(ids.shape[0]):
        seen = {}
        for i, v in enumerate(ids[gi]):
            out[gi, i] = seen.get(int(v), 0)
            seen[int(v)] = out[gi, i] + 1
    return out


@pytest.mark.parametrize("case", [dict(capacity_factor=1.0), dict(n_groups=2),
                                  dict(n_slots=6, capacity_factor=0.7)])
def test_route_decisions_equal_a_loop(case):
    dims = _dims(**case)
    _, tp, x = _layer(dims, seed=7, b=3, s=12)
    placement = None
    if dims.n_slots:
        placement = tmoe.tables_from_placement(tbal.balance_placement(
            np.array([50.0, 1, 1, 9]), 2, slots_per_device=3), device="cpu")
    r = tmoe.route(tp, dims, torch.from_numpy(x), placement)
    g = r.slot.shape[0]
    probs = r.probs.numpy()
    order = np.argsort(-probs, axis=-1, kind="stable")[..., :dims.top_k]
    assert np.array_equal(r.expert_ids.numpy(), order)
    top = np.take_along_axis(probs, order, -1)
    np.testing.assert_allclose(r.gate_w.numpy(), top / top.sum(-1, keepdims=True),
                               rtol=1e-6)
    flat_e = order.reshape(g, -1)
    if placement is None:
        want_slot = flat_e
    else:
        reps = placement.n_replicas.numpy()[flat_e]
        want_slot = placement.slot_of.numpy()[flat_e, _loop_ranks(flat_e) % reps]
    assert np.array_equal(r.slot.numpy(), want_slot)
    assert np.array_equal(r.pos.numpy(), _loop_ranks(want_slot))
    tgk = r.slot.shape[1]
    n_slots = dims.n_slots or dims.n_experts
    cap = max(1, int(dims.capacity_factor * (tgk // dims.top_k) * dims.top_k / n_slots))
    assert r.capacity == cap
    assert np.array_equal(r.keep.numpy(), r.pos.numpy() < cap)


@pytest.mark.parametrize("placed", [False, True], ids=["static", "awb"])
def test_route_in_parts_with_a_prior_is_the_whole_batch(placed):
    """Rows routed in parts, each with the counts of the parts before it
    (``RoutePrior``, as a mesh's data positions route): ranks, slots (the
    AWB replica from the batch-wide rank), capacity and drops equal the
    whole batch's; the outputs match it, and the parts' aux losses read
    with the batch's ce and weighted by their share sum to its aux."""
    dims = _dims(n_slots=6, capacity_factor=0.7) if placed else _dims(capacity_factor=0.7)
    _, tp, x = _layer(dims, seed=5, b=4, s=12)
    placement = None
    if placed:
        placement = tmoe.tables_from_placement(tbal.balance_placement(
            np.array([50.0, 1, 1, 9]), 2, slots_per_device=3), device="cpu")
    xt = torch.from_numpy(x)
    whole = tmoe.route(tp, dims, xt, placement)
    want_out, want_aux = tmoe.moe_forward(tp, dims, xt, placement)
    assert int((~whole.keep).sum()) > 0
    n_slots = dims.n_slots or dims.n_experts
    ce = torch.bincount(whole.expert_ids.reshape(-1), minlength=dims.n_experts).float() / (
        whole.expert_ids.numel())
    counts = (torch.zeros(dims.n_experts, dtype=torch.long),
              torch.zeros(n_slots, dtype=torch.long))
    parts, outs, aux = [], [], 0.0
    for lo, hi in ((0, 1), (1, 3), (3, 4)):
        prior = tmoe.RoutePrior(*counts, n_tokens=x.shape[0] * x.shape[1], ce=ce)
        r = tmoe.route(tp, dims, xt[lo:hi], placement, prior=prior)
        outs.append(tmoe.moe_apply(tp, dims, xt[lo:hi], r, placement, prior))
        aux += float(r.aux) * (hi - lo) / x.shape[0]
        counts = (counts[0] + torch.bincount(r.expert_ids.reshape(-1), minlength=dims.n_experts),
                  counts[1] + torch.bincount(r.slot.reshape(-1), minlength=n_slots))
        parts.append(r)
    for name in ("slot", "pos", "keep"):
        got = torch.cat([getattr(r, name) for r in parts], dim=-1)
        assert np.array_equal(got.numpy(), getattr(whole, name).numpy()), name
    assert all(r.capacity == whole.capacity for r in parts)
    assert float((torch.cat(outs) - want_out).abs().max()) <= ATOL
    assert abs(aux - float(want_aux)) <= ATOL


def test_rank_within_is_exact_on_long_runs():
    ids = np.random.default_rng(0).integers(0, 5, (3, 4000))
    got = tmoe.rank_within(torch.from_numpy(ids)).numpy()
    assert np.array_equal(got, _loop_ranks(ids))


def test_init_moe_params_shapes_and_scale():
    dims = _dims(n_experts=5, d_model=64, d_ff=32)
    p = tmoe.init_moe_params(torch.Generator().manual_seed(0), dims)
    jp = jmoe.init_moe_params(jax.random.PRNGKey(0), jmoe.MoEDims(*dims))
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in jp.items()}
    assert abs(float(p["w_in"].std()) - 64 ** -0.5) < 0.01
    assert abs(float(p["w_out"].std()) - 32 ** -0.5) < 0.01


# ---- serving a JAX-package checkpoint ----------------------------------------

def test_serve_restores_a_jax_moe_checkpoint(tmp_path, capsys):
    arch = "granite-moe-3b-a800m"
    cfg = jcfgs.get_reduced_config(arch)
    jp = jtr.init_params(cfg, jax.random.PRNGKey(4))
    jckpt.CheckpointManager(tmp_path).save(3, (jp,))
    outs = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path), "--prompts", "1 2 3;7 8",
                        "--max-new", "6"])
    assert "restored step 3" in capsys.readouterr().out
    assert outs == JaxEngine(cfg, jp, max_seq=64).generate([[1, 2, 3], [7, 8]],
                                                           max_new_tokens=6)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b"])
def test_serve_cli_runs_moe_archs(arch, capsys):
    outs = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--max-new", "4"])
    assert [len(o) for o in outs] == [7, 6]
    assert "tok/s" in capsys.readouterr().out


def test_reduced_moe_config_keeps_the_capacity_factor():
    from repro_torch import configs as tcfgs

    for arch in ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b"):
        t, j = tcfgs.get_reduced_config(arch), jcfgs.get_reduced_config(arch)
        assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe)
        assert tuple(t.moe_dims) == tuple(j.moe_dims)


# ---- exact ties in the router (lax.top_k puts the lower expert first) -------

def _tied_layer(seed=0, b=4, s=64):
    """A layer whose router has three pairs of equal columns and whose
    weights and inputs are small multiples of 1/2: logits are exact in f32
    and bf16, so equal columns give bit-equal probabilities in both
    packages, and rows tie at the k-th choice."""
    dims = _dims(n_experts=8, top_k=2)
    jp = jmoe.init_moe_params(jax.random.PRNGKey(seed), jmoe.MoEDims(*dims))
    rng = np.random.default_rng(seed)
    router = rng.integers(-2, 3, (dims.d_model, 8)).astype(np.float32) * 0.5
    router[:, 1], router[:, 5], router[:, 7] = router[:, 0], router[:, 4], router[:, 2]
    jp = dict(jp, router=jnp.asarray(router))
    x = rng.integers(-2, 3, (b, s, dims.d_model)).astype(np.float32)
    return dims, jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_breaks_exact_ties_as_lax_top_k(dtype, seed):
    dims, jp, tp, x = _tied_layer(seed)
    r = tmoe.route(tp, dims, torch.from_numpy(x).to(getattr(torch, dtype)))
    xt = jnp.asarray(x, getattr(jnp, dtype)).reshape(1, -1, dims.d_model)
    logits = (xt @ jp["router"].astype(xt.dtype)).astype(jnp.float32)
    probs = np.asarray(jax.nn.softmax(logits, axis=-1))
    _, ids = jax.lax.top_k(jnp.asarray(probs), dims.top_k)  # the reference's lines
    ranked = -np.sort(-probs, axis=-1)
    assert (ranked[..., dims.top_k - 1] == ranked[..., dims.top_k]).sum() > 10  # ties bite
    assert np.array_equal(r.expert_ids.numpy(), np.asarray(ids))
    # on the port's own probabilities too, which differ from JAX's in last bits
    _, own = jax.lax.top_k(jnp.asarray(r.probs.numpy()), dims.top_k)
    assert np.array_equal(r.expert_ids.numpy(), np.asarray(own))


def test_route_breaks_ties_in_quantised_probabilities():
    """4,096 rows of probabilities on a grid of 1/8: most rows tie."""
    e, k = 8, 3
    dims = _dims(d_model=e, n_experts=e, top_k=k)
    logits = np.random.default_rng(3).integers(0, 8, (1, 4096, e)).astype(np.float32) / 8
    tp = {"router": torch.eye(e)}
    r = tmoe.route(tp, dims, torch.from_numpy(logits))
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    ranked = -np.sort(-r.probs.numpy(), axis=-1)
    assert (ranked[..., k - 1] == ranked[..., k]).sum() > 1000
    _, ids = jax.lax.top_k(jnp.asarray(r.probs.numpy()), k)
    assert np.array_equal(r.expert_ids.numpy(), np.asarray(ids))
    _, jids = jax.lax.top_k(jnp.asarray(probs), k)
    assert np.array_equal(r.expert_ids.numpy(), np.asarray(jids))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_moe_forward_on_ties_matches_reference(seed):
    """The same bf16 inputs give the reference's output within bf16's own
    rounding (2^-7 of the output's scale); a tie broken the other way puts a
    different expert's output in a token's row, an O(1) difference."""
    dims, jp, tp, x = _tied_layer(seed)
    jo, ja = jmoe.moe_forward(jp, jmoe.MoEDims(*dims), jnp.asarray(x, jnp.bfloat16))
    to, ta = tmoe.moe_forward(tp, dims, torch.from_numpy(x).to(torch.bfloat16))
    want = np.asarray(jo.astype(jnp.float32))
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(), want,
                               atol=2 ** -7 * max(1.0, np.abs(want).max()), rtol=0)
    np.testing.assert_allclose(float(ta), float(ja), atol=ATOL, rtol=0)
