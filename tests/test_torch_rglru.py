"""Parity of the port's RG-LRU block (``models/rglru``) and of reduced
recurrentgemma-2b (``rglru`` and ``local`` layers) with the JAX package, on
the same weights (``params_from_jax``) and numpy inputs.

The block is held at 1e-5 in f32; the scan's parallel association against
a sequential loop at 1e-6. Model logits, prefill and every decode step are
held at 2e-3·max(1, |gold|max), the reference's decode-vs-forward
tolerance. In bf16 the two packages round at other places (``jax.nn.gelu``
rounds its intermediates, ``F.gelu`` once), so the bf16 logits are held
within 3× the reference's own bf16 error against its f32 logits."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfgs  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.transformer_serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.transformer_serve import ServeEngine  # noqa: E402

ARCH = "recurrentgemma-2b"
LM_TOL = 2e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _lm_close(got, want):
    want = np.asarray(want)
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, atol=LM_TOL * max(1.0, np.abs(want).max()),
                               rtol=0)


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------


def _block(d=32, dr=48, seed=0):
    dims = jrg.RGLRUDims(d, dr)
    jp = jrg.init_rglru_params(jax.random.PRNGKey(seed), dims)
    return dims, jp, {k: _t(v) for k, v in _np(jp).items()}


def _state(b, dr, seed):
    rng = np.random.default_rng(seed)
    return {"h": rng.standard_normal((b, dr)).astype(np.float32),
            "conv": rng.standard_normal((b, 3, dr)).astype(np.float32)}


def test_init_params_match_the_reference_layout():
    dims, jp, _ = _block()
    tp = trg.init_rglru_params(torch.Generator().manual_seed(0),
                               trg.RGLRUDims(*dims))
    assert tp.keys() == jp.keys()
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape and tp[k].dtype == torch.float32, k
    assert 2.0 <= float(tp["lam"].min()) and float(tp["lam"].max()) <= 6.0
    st = trg.init_rglru_state(trg.RGLRUDims(*dims), 3)
    jst = jrg.init_rglru_state(dims, 3)
    for k in ("h", "conv"):
        assert tuple(st[k].shape) == jst[k].shape and not st[k].any()
    assert st["h"].dtype == st["conv"].dtype == torch.float32


@pytest.mark.parametrize("s", [1, 2, 3, 5, 16, 37])
@pytest.mark.parametrize("zero_state", [True, False])
def test_rglru_forward_matches_jax(s, zero_state):
    dims, jp, tp = _block()
    x = np.random.default_rng(s).standard_normal((2, s, dims.d_model)).astype(np.float32)
    st = (_np(jrg.init_rglru_state(dims, 2)) if zero_state
          else _state(2, dims.d_rnn, s + 1))
    jo, jst = jrg.rglru_forward(jp, dims, jnp.asarray(x),
                                {k: jnp.asarray(v) for k, v in st.items()})
    to, tst = trg.rglru_forward(tp, trg.RGLRUDims(*dims), torch.from_numpy(x),
                                {k: torch.from_numpy(v) for k, v in st.items()})
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    for k in ("h", "conv"):
        assert tst[k].dtype == torch.float32 and tst[k].is_contiguous()
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), atol=1e-5, rtol=0)


def test_rglru_forward_matches_jax_in_bf16():
    dims, jp, tp = _block()
    x = np.random.default_rng(7).standard_normal((2, 12, dims.d_model)).astype(np.float32)
    st = _state(2, dims.d_rnn, 8)
    jo, jst = jrg.rglru_forward(jp, dims, jnp.asarray(x, jnp.bfloat16),
                                {k: jnp.asarray(v) for k, v in st.items()})
    to, tst = trg.rglru_forward(tp, trg.RGLRUDims(*dims),
                                torch.from_numpy(x).to(torch.bfloat16),
                                {k: torch.from_numpy(v) for k, v in st.items()})
    assert to.dtype == torch.bfloat16 and tst["h"].dtype == torch.float32
    want = np.asarray(jo.astype(jnp.float32))
    # bf16 keeps 8 significant bits: a few of its ulps at the output's scale
    np.testing.assert_allclose(to.float().numpy(), want,
                               atol=2 ** -6 * max(1.0, np.abs(want).max()), rtol=0)
    np.testing.assert_allclose(tst["h"].numpy(), np.asarray(jst["h"]), atol=2e-2, rtol=0)


@pytest.mark.parametrize("split", [1, 4, 9, 15])
def test_prefill_split_in_two_equals_one_call(split):
    dims, _, tp = _block(seed=1)
    d = trg.RGLRUDims(*dims)
    x = torch.from_numpy(np.random.default_rng(split).standard_normal(
        (2, 16, dims.d_model)).astype(np.float32))
    st = {k: torch.from_numpy(v) for k, v in _state(2, dims.d_rnn, 3).items()}
    whole, wst = trg.rglru_forward(tp, d, x, st)
    first, mid = trg.rglru_forward(tp, d, x[:, :split], st)
    second, est = trg.rglru_forward(tp, d, x[:, split:], mid)
    torch.testing.assert_close(torch.cat([first, second], 1), whole, atol=1e-5, rtol=0)
    for k in ("h", "conv"):
        torch.testing.assert_close(est[k], wst[k], atol=1e-5, rtol=0)


def test_state_carries_into_decode():
    """Step by step at S 1 (decode) equals one call over the sequence."""
    dims, _, tp = _block(seed=2)
    d = trg.RGLRUDims(*dims)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 10, dims.d_model)).astype(np.float32))
    st0 = trg.init_rglru_state(d, 3)
    whole, wst = trg.rglru_forward(tp, d, x, st0)
    st, outs = st0, []
    for t in range(10):
        o, st = trg.rglru_forward(tp, d, x[:, t:t + 1], st)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, 1), whole, atol=1e-5, rtol=0)
    torch.testing.assert_close(st["h"], wst["h"], atol=1e-5, rtol=0)
    torch.testing.assert_close(st["conv"], wst["conv"], atol=1e-6, rtol=0)


@pytest.mark.parametrize("s", [1, 2, 3, 4, 7, 8, 9, 64, 100])
def test_parallel_scan_equals_the_sequential_loop(s):
    rng = np.random.default_rng(s)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (2, s, 6)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, s, 6)).astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((2, 6)).astype(np.float32))
    a_in, g_in = a.clone(), g.clone()
    hs, last = trg._lru_scan(a, g, h0)
    assert torch.equal(a, a_in) and torch.equal(g, g_in)  # inputs left as they were
    h, want = h0, []
    for t in range(s):  # the reference's lax.scan step
        h = a[:, t] * h + torch.sqrt(torch.clamp(1.0 - a[:, t] * a[:, t], min=0.0)) * g[:, t]
        want.append(h)
    torch.testing.assert_close(hs, torch.stack(want, 1), atol=1e-6, rtol=0)
    torch.testing.assert_close(last, want[-1], atol=1e-6, rtol=0)


def test_scan_with_grad_equals_the_scan_without():
    """With grad the scan builds new buffers each round instead of writing
    in place: the same sums in the same order, so bit-equal outputs, and
    gradients that match finite differences."""
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (2, 37, 5)))
    g = torch.from_numpy(rng.standard_normal((2, 37, 5)))
    h0 = torch.from_numpy(rng.standard_normal((2, 5)))
    with torch.no_grad():
        hs, last = trg._lru_scan(a, g, h0)
    leaves = [t.clone().requires_grad_() for t in (a, g, h0)]
    ghs, glast = trg._lru_scan(*leaves)
    assert ghs.requires_grad and torch.equal(ghs.detach(), hs)
    assert torch.equal(glast.detach(), last)
    assert torch.autograd.gradcheck(lambda *x: trg._lru_scan(*x)[0].sum(), leaves)


def test_scan_survives_decays_near_zero():
    """log a_t down to −48 a step (r near 1, Λ at its top): the products
    underflow to 0 and h forgets, with no inf or NaN."""
    a = torch.full((1, 50, 4), float(np.exp(-48.0)))
    a[:, ::7] = 1.0
    g = torch.ones((1, 50, 4))
    hs, last = trg._lru_scan(a, g, torch.full((1, 4), 3.0))
    assert torch.isfinite(hs).all() and torch.isfinite(last).all()
    assert float(hs[0, 0, 0]) == 3.0  # a = 1 keeps the state and adds nothing
    torch.testing.assert_close(hs[0, 1:7], torch.ones((6, 4)), atol=1e-6, rtol=0)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(5)
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        x = rng.standard_normal((2, 6, 8)).astype(np.float32)
        w = rng.standard_normal((4, 8)).astype(np.float32)
        b = rng.standard_normal(8).astype(np.float32)
        cs = rng.standard_normal((2, 3, 8)).astype(np.float32)
        jy, jst = jrg._causal_conv(jnp.asarray(x, jdt), w, b, jnp.asarray(cs))
        ty, tst = trg._causal_conv(torch.from_numpy(x).to(dtype), _t(w), _t(b), _t(cs))
        assert ty.dtype == dtype and tst.dtype == torch.float32
        np.testing.assert_array_equal(ty.float().numpy(), np.asarray(jy.astype(jnp.float32)))
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


# ---------------------------------------------------------------------------
# reduced recurrentgemma-2b: (rglru, rglru, local) × 2 + (rglru, rglru)
# ---------------------------------------------------------------------------


def _models(seed=0):
    jcfg, tcfg = jcfgs.get_reduced_config(ARCH), tcfgs.get_reduced_config(ARCH)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, ttr.params_from_jax(tcfg, _np(jp), device="cpu")


def _tokens(jcfg, seed, b=2, s=12):
    return np.random.default_rng(seed).integers(0, jcfg.vocab, (b, s)).astype(np.int32)


def test_layer_kinds_unroll_the_hybrid_unit():
    full = ttr.layer_kinds(tcfgs.get_config(ARCH))
    assert full == ["rglru", "rglru", "local"] * 8 + ["rglru", "rglru"]
    _, tcfg, _, tp = _models()
    assert ttr.layer_kinds(tcfg) == ["rglru", "rglru", "local"] * 2 + ["rglru", "rglru"]
    assert [set(p) for p in tp["layers"][:3]] == [
        {"norm1", "rec", "norm2", "mlp"}, {"norm1", "rec", "norm2", "mlp"},
        {"norm1", "attn", "norm2", "mlp"}]


@pytest.mark.parametrize("seed", [0, 1])
def test_model_forward_matches_jax(seed):
    jcfg, tcfg, jp, tp = _models(seed)
    toks = _tokens(jcfg, seed + 10)
    jl, _ = jtr.model_forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                              compute_dtype=jnp.float32)
    tl, aux = ttr.model_forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                                compute_dtype=torch.float32)
    assert tl.shape == (2, 12, tcfg.vocab) and float(aux) == 0.0
    _lm_close(tl, jl)


def test_model_forward_matches_jax_in_bf16():
    jcfg, tcfg, jp, tp = _models(2)
    toks = _tokens(jcfg, 12)
    j16 = np.asarray(jtr.model_forward(jcfg, jp, {"tokens": jnp.asarray(toks)})[0]
                     .astype(jnp.float32))
    j32 = np.asarray(jtr.model_forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                       compute_dtype=jnp.float32)[0])
    t16, _ = ttr.model_forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert t16.dtype == torch.bfloat16
    own = np.abs(j16 - j32).max()
    assert 0 < np.abs(t16.float().numpy() - j16).max() <= 3 * own


@pytest.mark.parametrize("pre,max_seq", [(9, 12), (4, 14), (11, 14)])
def test_prefill_and_decode_match_jax(pre, max_seq):
    """Prefill of 4 then decode wraps the local layers' ring of 8; prefill
    of 11 scatters the last 8 positions to slots s % 8. Every step's logits
    and the caches (K/V ring, recurrent state) agree."""
    jcfg, tcfg, jp, tp = _models(3)
    toks = _tokens(jcfg, pre, s=max_seq)
    jl, jc = jtr.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :pre])},
                         max_seq=max_seq, compute_dtype=jnp.float32)
    tl, tc = ttr.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :pre])},
                         max_seq=max_seq, compute_dtype=torch.float32)
    _lm_close(tl, jl)
    for t in range(pre, max_seq):
        jl, jc = jtr.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, t]), jnp.int32(t),
                                 compute_dtype=jnp.float32)
        tl, tc = ttr.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, t]), t,
                                 compute_dtype=torch.float32)
        _lm_close(tl, jl)
    want = []
    for si, (unit, repeat) in enumerate(jcfg.segments):
        for r in range(repeat):
            for i in range(len(unit)):
                want.append({k: np.asarray(v[r]) for k, v in jc[f"seg{si}"][f"l{i}"].items()})
    for kind, got, w in zip(ttr.layer_kinds(tcfg), tc, want):
        assert got.keys() == w.keys()
        for k in w:
            assert tuple(got[k].shape) == w[k].shape, (kind, k)
            np.testing.assert_allclose(got[k].numpy(), w[k], atol=1e-4, rtol=0)
        if kind == "rglru":
            assert got["h"].dtype == got["conv"].dtype == torch.float32


def test_local_attention_ring_cache():
    """tests/test_models.py's ring-cache case on the port: windowed decode
    past the window equals the full forward, and the JAX package's decode."""
    jcfg, tcfg, jp, tp = _models(3)
    assert tcfg.window is not None and tcfg.window < 16
    b, s = 1, 14  # > window so the ring wraps
    toks = _tokens(jcfg, 3, b=b, s=s)
    logits, _ = ttr.model_forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                                  compute_dtype=torch.float32)
    _, cache = ttr.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :4])},
                           max_seq=s, compute_dtype=torch.float32)
    _, jc = jtr.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :4])}, max_seq=s,
                        compute_dtype=jnp.float32)
    errs = []
    for t in range(4, s):
        step, cache = ttr.decode_step(tcfg, tp, cache, torch.from_numpy(toks[:, t]), t,
                                      compute_dtype=torch.float32)
        jl, jc = jtr.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, t]), jnp.int32(t),
                                 compute_dtype=jnp.float32)
        errs.append(float((step[:, 0] - logits[:, t]).abs().max()))
        _lm_close(step, jl)
    assert max(errs) < 2e-3, errs


def test_decode_matches_forward_on_port_weights():
    _, tcfg, _, _ = _models()
    tp = ttr.init_params(tcfg, torch.Generator().manual_seed(4))
    toks = torch.randint(0, tcfg.vocab, (2, 14), generator=torch.Generator().manual_seed(6))
    logits, _ = ttr.model_forward(tcfg, tp, {"tokens": toks}, compute_dtype=torch.float32)
    last, cache = ttr.prefill(tcfg, tp, {"tokens": toks[:, :5]}, max_seq=14,
                              compute_dtype=torch.float32)
    errs = [float((last[:, 0] - logits[:, 4]).abs().max())]
    for t in range(5, 14):
        step, cache = ttr.decode_step(tcfg, tp, cache, toks[:, t], t,
                                      compute_dtype=torch.float32)
        errs.append(float((step[:, 0] - logits[:, t]).abs().max()))
    assert max(errs) < LM_TOL, errs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_engine_tokens_equal_jax(dtype):
    jcfg, tcfg, jp, tp = _models(5)
    prompts = [[3, 4, 5, 6, 7], [9, 10]]
    want = JaxEngine(jcfg, jp, max_seq=16, compute_dtype=getattr(jnp, dtype)).generate(
        prompts, 6)
    got = ServeEngine(tcfg, tp, max_seq=16, compute_dtype=getattr(torch, dtype),
                      device="cpu").generate(prompts, 6)
    if dtype == "float32":
        assert got == want
    else:  # bf16 ties may flip a late token; the prompts and first tokens agree
        assert [g[:len(p) + 1] for g, p in zip(got, prompts)] == [
            w[:len(p) + 1] for w, p in zip(want, prompts)]


def test_count_params_equals_the_reference():
    cfg = tcfgs.get_config(ARCH)
    assert ttr.count_params(cfg) == jtr.count_params(jcfgs.get_config(ARCH)) == 3_549_934_080
    red = tcfgs.get_reduced_config(ARCH)
    assert ttr.count_params(red) == jtr.count_params(jcfgs.get_reduced_config(ARCH))


def test_params_round_trip_the_jax_layout():
    jcfg, tcfg, jp, tp = _models(6)
    back = ttr.jax_layout(tcfg, tp)
    flat_j = jax.tree_util.tree_leaves_with_path(_np(jp))
    assert len(flat_j) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat_j:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf)
    again = ttr.params_from_jax(tcfg, back, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(tp)):
        assert torch.equal(a, b)


def test_hybrid_without_window_cut_still_decodes():
    """The local layers at a window wider than the sequence (the published
    2048 against a short prompt) keep a max_seq cache and match the JAX
    package."""
    jcfg, tcfg, _, _ = _models()
    jcfg = dataclasses.replace(jcfg, window=64)
    tcfg = dataclasses.replace(tcfg, window=64)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(8))
    tp = ttr.params_from_jax(tcfg, _np(jp), device="cpu")
    toks = _tokens(jcfg, 8, s=10)
    jl, jc = jtr.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :6])}, max_seq=10,
                         compute_dtype=jnp.float32)
    tl, tc = ttr.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :6])},
                         max_seq=10, compute_dtype=torch.float32)
    _lm_close(tl, jl)
    assert tc[2]["k"].shape[1] == 10
    for t in range(6, 10):
        jl, jc = jtr.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, t]), jnp.int32(t),
                                 compute_dtype=jnp.float32)
        tl, tc = ttr.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, t]), t,
                                 compute_dtype=torch.float32)
        _lm_close(tl, jl)
