"""Parity of the port's LM modules (``models/common``, ``mlp``,
``attention``, ``transformer``) with the JAX package on the reduced
qwen2-0.5b configuration and a windowed variant, with the same weights
(``params_from_jax``) and the same numpy inputs. Tolerance 1e-4 in f32; the
port's own decode-vs-forward check uses the JAX package's 2e-3. The MoE
models (reduced granite-moe and qwen3-moe, ``attn_moe``) are held at 2e-3
on logits and 1e-5 on the aux loss, at their own capacity factor (tokens
drop) and dropless."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfgs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402

ATOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), atol=atol, rtol=0)


def _models(variant, seed=0):
    """(jax cfg, port cfg, jax params, port params) for one variant."""
    jcfg = jcfgs.get_reduced_config("qwen2-0.5b")
    tcfg = tcfgs.get_reduced_config("qwen2-0.5b")
    if variant == "windowed":
        kw = dict(segments=((("local", "attn"), 2),), n_layers=4, window=8)
        jcfg = dataclasses.replace(jcfg, **kw)
        tcfg = dataclasses.replace(tcfg, **kw)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
    # non-zero biases so the QKV-bias path is exercised
    for name in ("bq", "bk", "bv"):
        leaf = jp["seg0"]["l0"]["attn"][name]
        jp["seg0"]["l0"]["attn"][name] = jax.random.normal(
            jax.random.PRNGKey(seed + 7), leaf.shape) * 0.1
    return jcfg, tcfg, jp, ttr.params_from_jax(tcfg, _np(jp), device="cpu")


def _layer_caches(jcfg, jcache):
    """The JAX package's stacked per-segment caches as the port's list."""
    out = []
    for si, (unit, repeat) in enumerate(jcfg.segments):
        for r in range(repeat):
            for i in range(len(unit)):
                out.append({k: np.asarray(v[r])
                            for k, v in jcache[f"seg{si}"][f"l{i}"].items()})
    return out


# ---------------------------------------------------------------------------
# common, mlp
# ---------------------------------------------------------------------------


def test_common_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    _close(tcommon.rmsnorm(_t(x), _t(w)), jcommon.rmsnorm(jnp.asarray(x), w))
    _close(tcommon.layernorm(_t(x), _t(w), _t(bias)),
           jcommon.layernorm(jnp.asarray(x), w, bias))
    for kind in ("rmsnorm", "layernorm"):
        jp = _np(jcommon.norm_params(kind, 16))
        tp = tcommon.norm_params(kind, 16)
        assert jp.keys() == tp.keys()
        _close(tcommon.apply_norm(kind, _t(x), tp), jcommon.apply_norm(kind, x, jp))
    _close(tcommon.rope_freqs(16, 1e6), jcommon.rope_freqs(16, 1e6), atol=1e-9)
    pos = np.array([[0, 1, 2, 7, 1000]] * 2, np.int32)
    for theta in (1e4, 1e6):
        _close(tcommon.apply_rope(_t(x), torch.from_numpy(pos), theta),
               jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    for name in ("silu", "gelu", "relu", "relu2", "tanh"):
        _close(tcommon.activation_fn(name)(_t(x)),
               jcommon.activation_fn(name)(jnp.asarray(x)), atol=1e-6)


def test_rope_is_split_halves():
    x = torch.zeros((1, 1, 1, 4))
    x[..., 0] = 1.0  # first channel of the first half
    out = tcommon.apply_rope(x, torch.tensor([[1]]), theta=1.0)
    # rotates against channel 2 (the first of the second half), not channel 1
    assert abs(float(out[..., 1])) < 1e-7 and abs(float(out[..., 2])) > 0.5


def test_dense_init_uses_the_generator():
    a = tcommon.dense_init(torch.Generator().manual_seed(3), (64, 8))
    b = tcommon.dense_init(torch.Generator().manual_seed(3), (64, 8))
    assert torch.equal(a, b)
    assert abs(float(a.std()) - 64 ** -0.5) < 0.03


@pytest.mark.parametrize("glu,act", [(True, "silu"), (False, "gelu")])
def test_mlp_matches_jax(glu, act):
    jp = jmlp.init_mlp_params(jax.random.PRNGKey(1), 32, 48, glu)
    x = np.random.default_rng(1).standard_normal((2, 6, 32)).astype(np.float32)
    tp = {k: _t(v) for k, v in _np(jp).items()}
    _close(tmlp.mlp_forward(tp, _t(x), act, glu),
           jmlp.mlp_forward(jp, jnp.asarray(x), act, glu))
    assert tmlp.init_mlp_params(torch.Generator(), 32, 48, glu).keys() == jp.keys()


# ---------------------------------------------------------------------------
# attention layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 8])
def test_attention_layer_matches_jax(window):
    jcfg, tcfg, jp, tp = _models("plain")
    dims_j, dims_t = jcfg.attn_dims(window), tcfg.attn_dims(window)
    assert tuple(dims_j) == tuple(dims_t)
    pj, pt = jp["seg0"]["l0"]["attn"], tp["layers"][0]["attn"]
    pj = jax.tree.map(lambda a: a[0], pj)
    x = np.random.default_rng(2).standard_normal((2, 12, 64)).astype(np.float32)
    _close(tattn.attn_forward(pt, dims_t, _t(x)),
           jattn.attn_forward(pj, dims_j, jnp.asarray(x)))
    for s, max_seq in ((12, 16), (12, 6)):  # the second outruns the cache: ring scatter
        jc = jattn.init_kv_cache(dims_j, 2, max_seq, jnp.float32)
        tc = tattn.init_kv_cache(dims_t, 2, max_seq, torch.float32)
        assert tc["k"].shape == jc["k"].shape
        jo, jc = jattn.attn_prefill(pj, dims_j, jnp.asarray(x[:, :s]), jc)
        to, tc = tattn.attn_prefill(pt, dims_t, _t(x[:, :s]), tc)
        _close(to, jo)
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])
        for pos in (s, s + 3, 40):  # 40 is past the cache's end: clamped slot
            xt = np.random.default_rng(pos).standard_normal((2, 1, 64)).astype(np.float32)
            jo, jc = jattn.attn_decode(pj, dims_j, jnp.asarray(xt), jc, jnp.int32(pos))
            to, tc = tattn.attn_decode(pt, dims_t, _t(xt), tc, pos)
            _close(to, jo)
            _close(tc["k"], jc["k"])
            _close(tc["v"], jc["v"])


# ---------------------------------------------------------------------------
# transformer
# ---------------------------------------------------------------------------


def test_params_from_jax_layout():
    jcfg, tcfg, jp, tp = _models("windowed")
    assert len(tp["layers"]) == 4 and "lm_head" not in tp
    # layer 2l + i of the port is repeat l, unit slot i of the JAX segment
    np.testing.assert_array_equal(tp["layers"][3]["attn"]["wq"].numpy(),
                                  np.asarray(jp["seg0"]["l1"]["attn"]["wq"][1]))
    tinit = ttr.init_params(tcfg, torch.Generator().manual_seed(0))
    assert tinit.keys() == tp.keys()
    assert tinit["layers"][0].keys() == tp["layers"][0].keys()

    def shapes(tree, path=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items() for k2, v2 in shapes(v, f"{path}/{k}").items()}
        if isinstance(tree, list):
            return {k2: v2 for i, v in enumerate(tree) for k2, v2 in shapes(v, f"{path}/{i}").items()}
        return {path: tuple(tree.shape)}

    assert shapes(tinit) == shapes(tp)


@pytest.mark.parametrize("variant", ["plain", "windowed"])
def test_model_forward_matches_jax(variant):
    jcfg, tcfg, jp, tp = _models(variant)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
    jl, _ = jtr.model_forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                              compute_dtype=jnp.float32)
    tl, aux = ttr.model_forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                                compute_dtype=torch.float32)
    assert tl.shape == (2, 12, jcfg.vocab) and float(aux) == 0.0
    _close(tl, jl)


@pytest.mark.parametrize("variant,pre,max_seq", [
    ("plain", 9, 12), ("windowed", 4, 14), ("windowed", 11, 14)])
def test_prefill_and_decode_match_jax(variant, pre, max_seq):
    """Windowed: prefill of 4 then decode wraps the ring of 8; prefill of 11
    scatters the last 8 positions to slots s % 8."""
    jcfg, tcfg, jp, tp = _models(variant)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (2, max_seq)).astype(np.int32)
    jl, jc = jtr.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :pre])},
                         max_seq=max_seq, compute_dtype=jnp.float32)
    tl, tc = ttr.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :pre])},
                         max_seq=max_seq, compute_dtype=torch.float32)
    assert tl.shape == (2, 1, jcfg.vocab)
    _close(tl, jl)
    for t in range(pre, max_seq):
        jl, jc = jtr.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, t]), jnp.int32(t),
                                 compute_dtype=jnp.float32)
        tl, tc = ttr.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, t]), t,
                                 compute_dtype=torch.float32)
        _close(tl, jl)
    for got, want in zip(tc, _layer_caches(jcfg, jc)):
        assert got["k"].shape == want["k"].shape
        _close(got["k"], want["k"])
        _close(got["v"], want["v"])


@pytest.mark.parametrize("variant", ["plain", "windowed"])
def test_decode_matches_forward(variant):
    _, tcfg, _, _ = _models(variant)
    tp = ttr.init_params(tcfg, torch.Generator().manual_seed(2))
    toks = torch.randint(0, tcfg.vocab, (2, 14), generator=torch.Generator().manual_seed(5))
    logits, _ = ttr.model_forward(tcfg, tp, {"tokens": toks}, compute_dtype=torch.float32)
    pre = 4
    last, cache = ttr.prefill(tcfg, tp, {"tokens": toks[:, :pre]}, max_seq=14,
                              compute_dtype=torch.float32)
    errs = [float((last[:, 0] - logits[:, pre - 1]).abs().max())]
    for t in range(pre, 14):
        step, cache = ttr.decode_step(tcfg, tp, cache, toks[:, t], t,
                                      compute_dtype=torch.float32)
        errs.append(float((step[:, 0] - logits[:, t]).abs().max()))
    assert max(errs) < 2e-3, errs


def test_every_kind_of_every_config_is_ported():
    """``layer_kinds`` accepts every kind of the ten configs, and every
    reduced config builds its parameters."""
    for arch in tcfgs.list_archs():
        kinds = set(ttr.layer_kinds(tcfgs.get_config(arch)))
        assert kinds <= set(ttr._KINDS), arch
        ttr.init_params(tcfgs.get_reduced_config(arch), torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="unknown layer kind"):
        ttr.layer_kinds(dataclasses.replace(tcfgs.get_reduced_config("qwen2-0.5b"),
                                            segments=((("mamba",), 1),)))


# ---------------------------------------------------------------------------
# MoE models (attn_moe): logits within 2e-3, aux losses within 1e-5
# ---------------------------------------------------------------------------

MOE_ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b"]


def _moe_models(arch, capacity_factor=None, seed=0, **kw):
    """(jax cfg, port cfg, jax params, port params) for a reduced MoE arch,
    at its own capacity factor or the one given."""
    jcfg = jcfgs.get_reduced_config(arch)
    tcfg = tcfgs.get_reduced_config(arch)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=capacity_factor))
    jcfg, tcfg = dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, ttr.params_from_jax(tcfg, _np(jp), device="cpu")


@pytest.mark.parametrize("cf", [None, 64.0], ids=["default_capacity", "dropless"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_forward_matches_jax(arch, cf):
    jcfg, tcfg, jp, tp = _moe_models(arch, cf)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    jl, ja = jtr.model_forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                               compute_dtype=jnp.float32)
    tl, ta = ttr.model_forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                               compute_dtype=torch.float32)
    assert tl.shape == (2, 16, jcfg.vocab)
    _close(tl, jl, atol=2e-3)
    _close(ta, ja, atol=1e-5)
    assert float(ta) > 0


@pytest.mark.parametrize("cf", [None, 64.0], ids=["default_capacity", "dropless"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_decode_match_jax(arch, cf):
    jcfg, tcfg, jp, tp = _moe_models(arch, cf, seed=1)
    pre, max_seq = 9, 14
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (2, max_seq)).astype(np.int32)
    jl, jc = jtr.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :pre])},
                         max_seq=max_seq, compute_dtype=jnp.float32)
    tl, tc = ttr.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :pre])},
                         max_seq=max_seq, compute_dtype=torch.float32)
    _close(tl, jl, atol=2e-3)
    for t in range(pre, max_seq):
        jl, jc = jtr.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, t]), jnp.int32(t),
                                 compute_dtype=jnp.float32)
        tl, tc = ttr.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, t]), t,
                                 compute_dtype=torch.float32)
        _close(tl, jl, atol=2e-3)
    for got, want in zip(tc, _layer_caches(jcfg, jc)):
        _close(got["k"], want["k"], atol=2e-3)
        _close(got["v"], want["v"], atol=2e-3)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_matches_forward(arch):
    """Dropless (capacity factor 64), as the JAX package's own test."""
    _, tcfg, _, _ = _moe_models(arch, 64.0)
    tp = ttr.init_params(tcfg, torch.Generator().manual_seed(2))
    toks = torch.randint(0, tcfg.vocab, (2, 12), generator=torch.Generator().manual_seed(5))
    logits, _ = ttr.model_forward(tcfg, tp, {"tokens": toks}, compute_dtype=torch.float32)
    pre = 9
    last, cache = ttr.prefill(tcfg, tp, {"tokens": toks[:, :pre]}, max_seq=12,
                              compute_dtype=torch.float32)
    errs = [float((last[:, 0] - logits[:, pre - 1]).abs().max())]
    for t in range(pre, 12):
        step, cache = ttr.decode_step(tcfg, tp, cache, toks[:, t], t,
                                      compute_dtype=torch.float32)
        errs.append(float((step[:, 0] - logits[:, t]).abs().max()))
    assert max(errs) < 2e-3, errs


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_groups_match_baseline(arch):
    """Grouped dispatch (4 groups) and chunked attention give the baseline's
    logits, dropless, as ``tests/test_perf_variants.py`` holds the
    reference."""
    _, tcfg, _, tp = _moe_models(arch, 64.0)
    copt = dataclasses.replace(tcfg, attn_chunk=8, moe_groups=4)
    assert copt.moe_dims.n_groups == 4
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, tcfg.vocab, (2, 16)).astype(np.int32))
    base, _ = ttr.model_forward(tcfg, tp, {"tokens": toks}, compute_dtype=torch.float32)
    opt, _ = ttr.model_forward(copt, tp, {"tokens": toks}, compute_dtype=torch.float32)
    _close(opt, base, atol=2e-4)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_grouped_dispatch_matches_jax(arch):
    """4 dispatch groups at the default capacity: ranks and drops per group."""
    jcfg, tcfg, jp, tp = _moe_models(arch, moe_groups=4)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    jl, ja = jtr.model_forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                               compute_dtype=jnp.float32)
    tl, ta = ttr.model_forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                               compute_dtype=torch.float32)
    _close(tl, jl, atol=2e-3)
    _close(ta, ja, atol=1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_param_counts_match_jax(arch):
    jcfg, tcfg = jcfgs.get_config(arch), tcfgs.get_config(arch)
    assert ttr.count_params(tcfg) == jtr.count_params(jcfg)
    assert ttr.active_params(tcfg) == jtr.active_params(jcfg)
    assert ttr.active_params(tcfg) < ttr.count_params(tcfg)
    dense = tcfgs.get_config("qwen2-0.5b")
    assert ttr.active_params(dense) == ttr.count_params(dense)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_params_round_trip_the_jax_layout(arch):
    jcfg, tcfg, jp, tp = _moe_models(arch)
    assert "moe" in tp["layers"][0] and "mlp" not in tp["layers"][0]
    assert tp["layers"][1]["moe"]["w_in"].shape == (tcfg.moe.n_experts, tcfg.d_model,
                                                    tcfg.moe.d_expert)
    back = jax.tree.leaves(jax.tree.map(np.asarray, ttr.jax_layout(tcfg, tp)))
    want = jax.tree.leaves(_np(jp))
    assert len(back) == len(want)
    for a, b in zip(back, want):
        np.testing.assert_array_equal(a, b)
    tinit = ttr.init_params(tcfg, torch.Generator().manual_seed(0))
    assert tinit["layers"][0]["moe"].keys() == tp["layers"][0]["moe"].keys()
