"""Parity of the port's RWKV-6 block (``models/rwkv6``) and of reduced
rwkv6-3b (``rwkv`` layers) with the JAX package, on the same weights
(``params_from_jax``) and numpy inputs.

The block's parts are held at 1e-5·max(1, |gold|max) in f32; in bf16 the
two packages round at other places, so within 2^-6 of the output's scale
(a few bf16 ulps). The chunked wkv is held against the reference's
``_wkv_scan`` at 1e-5·max(1, |gold|max), outputs and state, at lengths that
cut the chunks at every edge, for two chunk sizes. Model logits, prefill and
every decode step are held at 2e-3·max(1, |gold|max), the reference's
decode-vs-forward tolerance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfgs  # noqa: E402
from repro.models import rwkv6 as jrw  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.transformer_serve import ServeEngine as JaxEngine  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.models import rwkv6 as trw  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.transformer_serve import ServeEngine  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.training.tree import tree_map  # noqa: E402

ARCH = "rwkv6-3b"
LM_TOL = 2e-3
TOL = 1e-5
CHUNKS = (4, 16)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, tol=TOL):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, np.abs(want).max()), rtol=0)


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------


def _block(seed=0, d=32, h=2, dh=16, d_ff=48, lora_r=8):
    """(dims, the JAX package's params, the port's): the port's seeded
    init, with a non-trivial bonus, decay and group-norm weight so each
    path counts, handed to both packages as the same numbers."""
    dims = jrw.RWKVDims(d, h, dh, d_ff, lora_r)
    tp = trw.init_rwkv_params(torch.Generator().manual_seed(seed), trw.RWKVDims(*dims))
    rng = np.random.default_rng(seed)
    tp.update(u=_t(rng.standard_normal((h, dh))), w0=_t(rng.uniform(-6, 1, h * dh)),
              ln_x=_t(rng.uniform(0.5, 1.5, h * dh)))
    return dims, {k: jnp.asarray(v.numpy()) for k, v in tp.items()}, tp


def _inputs(dims, b, s, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, dims.d_model)).astype(np.float32)
    x_prev = rng.standard_normal((b, 1, dims.d_model)).astype(np.float32)
    state = rng.standard_normal((b, dims.n_heads, dims.d_head, dims.d_head)).astype(
        np.float32)
    return x, x_prev, state


def test_init_params_match_the_reference_layout():
    dims, _, tp = _block()
    jp = jrw.init_rwkv_params(jax.random.PRNGKey(0), dims)
    assert tp.keys() == jp.keys()
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape and tp[k].dtype == torch.float32, k
    st, jst = trw.init_rwkv_state(trw.RWKVDims(*dims), 3), jrw.init_rwkv_state(dims, 3)
    for k in jst:
        assert tuple(st[k].shape) == jst[k].shape and not st[k].any()
        assert st[k].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ddlerp_matches_jax(dtype):
    dims, jp, tp = _block(1)
    x, x_prev, _ = _inputs(dims, 2, 7, 2)
    shifted = np.concatenate([x_prev, x[:, :-1]], 1)
    want = jrw._ddlerp(jp, jnp.asarray(x, dtype), jnp.asarray(shifted, dtype))
    got = trw._ddlerp(tp, torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(shifted).to(getattr(torch, dtype)))
    assert len(got) == 5
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        _close(g, w.astype(jnp.float32), TOL if dtype == "float32" else 2 ** -6)


@pytest.mark.parametrize("s", [1, 5, 21])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_mix_matches_jax(s, dtype):
    dims, jp, tp = _block(2)
    x, x_prev, state = _inputs(dims, 2, s, s)
    jo, jx, jst = jrw.rwkv_time_mix(jp, dims, jnp.asarray(x, dtype), jnp.asarray(x_prev),
                                    jnp.asarray(state))
    to, tx, tst = trw.rwkv_time_mix(tp, trw.RWKVDims(*dims),
                                    torch.from_numpy(x).to(getattr(torch, dtype)),
                                    torch.from_numpy(x_prev), torch.from_numpy(state),
                                    chunk=CHUNKS[0])
    assert to.dtype == getattr(torch, dtype) and tst.dtype == torch.float32
    tol = TOL if dtype == "float32" else 2 ** -6
    _close(to, jo.astype(jnp.float32), tol)
    _close(tx, jx.astype(jnp.float32), 0)
    _close(tst, jst, TOL if dtype == "float32" else 2 ** -6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_mix_matches_jax(dtype):
    dims, jp, tp = _block(3)
    x, x_prev, _ = _inputs(dims, 2, 9, 4)
    jo, jx = jrw.rwkv_channel_mix(jp, jnp.asarray(x, dtype), jnp.asarray(x_prev, dtype))
    to, tx = trw.rwkv_channel_mix(tp, torch.from_numpy(x).to(getattr(torch, dtype)),
                                  torch.from_numpy(x_prev).to(getattr(torch, dtype)))
    assert to.dtype == getattr(torch, dtype)
    _close(to, jo.astype(jnp.float32), TOL if dtype == "float32" else 2 ** -6)
    _close(tx, jx.astype(jnp.float32), 0)


def test_sequential_and_chunked_time_mix_agree():
    dims, _, tp = _block(4)
    x, x_prev, state = _inputs(dims, 2, 19, 5)
    args = (tp, trw.RWKVDims(*dims), torch.from_numpy(x), torch.from_numpy(x_prev),
            torch.from_numpy(state))
    plain = trw.rwkv_time_mix(*args, chunk=None)
    for c in CHUNKS:
        for a, b in zip(trw.rwkv_time_mix(*args, chunk=c), plain):
            torch.testing.assert_close(a, b, atol=TOL * max(1.0, float(b.abs().max())),
                                       rtol=0)


# ---------------------------------------------------------------------------
# the wkv recurrence
# ---------------------------------------------------------------------------


def _wkv_inputs(s, seed, w0=-5.0, b=2, h=3, dh=8):
    """r, k, v, u, state from the seed; decay = w0 + N(0, 0.5²), the
    seeded model's spread; returns log w and w = exp(log w) beside."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, dh)).astype(np.float32) for _ in range(3))
    decay = (w0 + 0.5 * rng.standard_normal((b, s, h, dh))).astype(np.float32)
    log_w = -np.exp(decay)
    u = rng.standard_normal((h, dh)).astype(np.float32)
    state = rng.standard_normal((b, h, dh, dh)).astype(np.float32)
    return r, k, v, log_w, u, state


def _reference_wkv(r, k, v, log_w, u, state):
    out, st = jrw._wkv_scan(*(jnp.asarray(a) for a in (r, k, v, np.exp(log_w), u, state)))
    return np.asarray(out), np.asarray(st)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("edge", ["1", "C-1", "C", "C+1", "3C+5"])
def test_chunked_wkv_matches_the_reference_scan(chunk, edge):
    s = {"1": 1, "C-1": chunk - 1, "C": chunk, "C+1": chunk + 1,
         "3C+5": 3 * chunk + 5}[edge]
    inputs = _wkv_inputs(s, s + chunk)
    want_out, want_state = _reference_wkv(*inputs)
    out, state = trw.wkv_chunked(*map(torch.from_numpy, inputs), chunk=chunk)
    assert out.shape == want_out.shape and state.shape == want_state.shape
    _close(out, want_out)
    _close(state, want_state)


@pytest.mark.parametrize("s", [1, 6])
def test_sequential_wkv_matches_the_reference_scan(s):
    inputs = _wkv_inputs(s, 40 + s)
    want_out, want_state = _reference_wkv(*inputs)
    out, state = trw.wkv_sequential(*map(torch.from_numpy, inputs))
    _close(out, want_out)
    _close(state, want_state)


@pytest.mark.parametrize("chunk", [16, 32])
def test_chunked_wkv_survives_strong_decay(chunk):
    """w0 = +2: log w ≈ −7.4 a token, so a chunk's cumulative log-decay A
    reaches about −7.4·C (−118 at C 16, −236 at C 32). The factorised form
    r·e^{A} against k·e^{−A} needs e^{−A} > 3.4e38, the f32 maximum, once
    −A passes about 88: it overflows to inf, and inf·0 gives NaN (asserted
    below on these inputs). With ``wkv_chunked`` rewritten to the
    factorised form on a scratch copy, this test failed with non-finite
    outputs; the chunked scan's factors are each a decay ≤ 1 and stay
    within tolerance."""
    inputs = _wkv_inputs(3 * chunk + 5, chunk, w0=2.0)
    log_w = torch.from_numpy(inputs[3])
    a = torch.cumsum(log_w[:, :chunk], dim=1)
    assert float(a.min()) < -88.0 and not torch.isfinite(torch.exp(-a)).all()
    want_out, want_state = _reference_wkv(*inputs)
    out, state = trw.wkv_chunked(*map(torch.from_numpy, inputs), chunk=chunk)
    assert torch.isfinite(out).all() and torch.isfinite(state).all()
    _close(out, want_out)
    _close(state, want_state)


def test_chunked_wkv_keeps_weak_decays_after_a_strong_one():
    """One token of log w = −200 then decays of −0.007 a token: each span's
    decay is summed directly, so the later spans keep their digits (a
    difference of two running sums near −200 would lose them to f32
    rounding, ~1.5e-5 of each factor)."""
    r, k, v, _, u, state = _wkv_inputs(20, 7)
    log_w = np.full(r.shape, -0.007, np.float32)
    log_w[:, 1] = -200.0
    inputs = (r, k, v, log_w, u, state)
    want_out, want_state = _reference_wkv(*inputs)
    out, st = trw.wkv_chunked(*map(torch.from_numpy, inputs), chunk=16)
    _close(out, want_out, 1e-6)
    _close(st, want_state, 1e-6)


def test_scans_do_not_drift_over_repeated_tokens():
    """1,500 copies of one token (a left-padded prompt) at the seeded decay
    w = exp(−e^{−5}) ≈ 0.9933: the state nears its fixed point kᵀv/(1 − w),
    which an error in w or in one step moves by 1/(1 − w) ≈ 150 times
    itself. Against a float64 loop in numpy, the chunked scan (decays from
    sums of log w taken directly) stays within 2e-6 of the output's scale
    and the float64 plain version within 2e-7; the reference's f32
    ``_wkv_scan`` drifts more than 5× as far as the chunked scan."""
    rng = np.random.default_rng(0)
    b, s, h, dh = 1, 1500, 2, 8
    r, k, v = (np.repeat(rng.standard_normal((b, 1, h, dh)).astype(np.float32), s, 1)
               for _ in range(3))
    log_w = np.full((b, s, h, dh), -np.exp(-5.0), np.float32)
    u, state = np.zeros((h, dh), np.float32), np.zeros((b, h, dh, dh), np.float32)
    w, st, outs = np.exp(log_w.astype(np.float64)), np.zeros((b, h, dh, dh)), []
    for t in range(s):
        kv = k[:, t, :, :, None].astype(np.float64) * v[:, t, :, None, :]
        outs.append(np.einsum("bhk,bhkv->bhv", r[:, t], st))
        st = w[:, t, :, :, None] * st + kv
    gold = np.stack(outs, 1)
    scale = np.abs(gold).max()
    inputs = tuple(map(torch.from_numpy, (r, k, v, log_w, u, state)))
    chunked = np.abs(trw.wkv_chunked(*inputs, chunk=16)[0].numpy() - gold).max() / scale
    plain = np.abs(trw.wkv_sequential(*inputs)[0].numpy() - gold).max() / scale
    reference = np.abs(_reference_wkv(r, k, v, log_w, u, state)[0] - gold).max() / scale
    assert chunked <= 2e-6 and plain <= 2e-7
    assert reference > 5 * chunked


def test_chunked_wkv_is_differentiable():
    inputs = [torch.from_numpy(a).double().requires_grad_(i in (0, 1, 2, 3, 5))
              for i, a in enumerate(_wkv_inputs(7, 3, b=1, h=1, dh=3))]

    def both(*args):
        out, st = trw.wkv_chunked(*args, chunk=4)
        return out.sum() + st.sum()

    assert torch.autograd.gradcheck(both, inputs)


# ---------------------------------------------------------------------------
# reduced rwkv6-3b: 2 rwkv layers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, port cfg, JAX params, port params): the port's seeded init,
    carried to the JAX package's layout by ``jax_layout``."""
    jcfg, tcfg = jcfgs.get_reduced_config(ARCH), tcfgs.get_reduced_config(ARCH)
    tp = ttr.init_params(tcfg, torch.Generator().manual_seed(0))
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), ttr.jax_layout(tcfg, tp))
    return jcfg, tcfg, jp, tp


def _tokens(seed, b=2, s=12):
    return np.random.default_rng(seed).integers(0, 128, (b, s)).astype(np.int32)


def test_layer_kinds_and_params(models):
    assert ttr.layer_kinds(tcfgs.get_config(ARCH)) == ["rwkv"] * 32
    jcfg, tcfg, jp, tp = models
    assert ttr.layer_kinds(tcfg) == ["rwkv"] * 2
    assert [set(p) for p in tp["layers"]] == [{"norm1", "rwkv", "norm2"}] * 2
    tinit = ttr.init_params(tcfg, torch.Generator().manual_seed(0))
    assert tinit.keys() == tp.keys()
    assert [p["rwkv"].keys() for p in tinit["layers"]] == [
        p["rwkv"].keys() for p in tp["layers"]]
    np.testing.assert_array_equal(tp["layers"][1]["rwkv"]["lora_b"].numpy(),
                                  np.asarray(jp["seg0"]["l0"]["rwkv"]["lora_b"][1]))


def test_count_params_equals_the_reference():
    assert (ttr.count_params(tcfgs.get_config(ARCH))
            == jtr.count_params(jcfgs.get_config(ARCH)))
    assert abs(ttr.count_params(tcfgs.get_config(ARCH)) - 3.1e9) / 3.1e9 < 0.06
    assert (ttr.count_params(tcfgs.get_reduced_config(ARCH))
            == jtr.count_params(jcfgs.get_reduced_config(ARCH)))


@pytest.mark.parametrize("seed", [0, 1])
def test_model_forward_matches_jax(models, seed):
    jcfg, tcfg, jp, tp = models
    toks = _tokens(seed + 10, s=37)
    jl, _ = jtr.model_forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                              compute_dtype=jnp.float32)
    for backend in (None, "torch"):  # the chunked scan, then the sequential one
        tl, aux = ttr.model_forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                                    backend=backend, compute_dtype=torch.float32)
        assert tl.shape == (2, 37, tcfg.vocab) and float(aux) == 0.0
        _close(tl, jl, LM_TOL)


def test_model_forward_matches_jax_in_bf16(models):
    jcfg, tcfg, jp, tp = models
    toks = _tokens(12)
    j16 = np.asarray(jtr.model_forward(jcfg, jp, {"tokens": jnp.asarray(toks)})[0]
                     .astype(jnp.float32))
    j32 = np.asarray(jtr.model_forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                       compute_dtype=jnp.float32)[0])
    t16, _ = ttr.model_forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert t16.dtype == torch.bfloat16
    own = np.abs(j16 - j32).max()
    assert np.abs(t16.float().numpy() - j16).max() <= 3 * own


@pytest.mark.parametrize("pre,max_seq", [(1, 4), (9, 11), (20, 22)])
def test_prefill_and_decode_match_jax(models, pre, max_seq):
    """Every step's logits and the caches (``tm_x``, ``cm_x``, ``wkv``, all
    f32) agree."""
    jcfg, tcfg, jp, tp = models
    toks = _tokens(pre, s=max_seq)
    jl, jc = jtr.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :pre])},
                         max_seq=max_seq, compute_dtype=jnp.float32)
    tl, tc = ttr.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :pre])},
                         max_seq=max_seq, compute_dtype=torch.float32)
    _close(tl, jl, LM_TOL)
    for t in range(pre, max_seq):
        jl, jc = jtr.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, t]), jnp.int32(t),
                                 compute_dtype=jnp.float32)
        tl, tc = ttr.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, t]), t,
                                 compute_dtype=torch.float32)
        _close(tl, jl, LM_TOL)
    for r, got in enumerate(tc):
        want = {k: np.asarray(v[r]) for k, v in jc["seg0"]["l0"].items()}
        assert got.keys() == want.keys()
        for k in want:
            assert tuple(got[k].shape) == want[k].shape and got[k].dtype == torch.float32
            assert got[k].is_contiguous()
            _close(got[k], want[k], 1e-4)


def test_prefill_in_two_calls_equals_one(models):
    """The state carries across calls: a prompt prefilled, then the rest
    decoded token by token, equals the forward over the whole sequence."""
    _, tcfg, _, _ = models
    tp = ttr.init_params(tcfg, torch.Generator().manual_seed(4))
    toks = torch.from_numpy(_tokens(6, s=14))
    logits, _ = ttr.model_forward(tcfg, tp, {"tokens": toks}, compute_dtype=torch.float32)
    last, cache = ttr.prefill(tcfg, tp, {"tokens": toks[:, :5]}, max_seq=14,
                              compute_dtype=torch.float32)
    errs = [float((last[:, 0] - logits[:, 4]).abs().max())]
    for t in range(5, 14):
        step, cache = ttr.decode_step(tcfg, tp, cache, toks[:, t], t,
                                      compute_dtype=torch.float32)
        errs.append(float((step[:, 0] - logits[:, t]).abs().max()))
    assert max(errs) < LM_TOL * max(1.0, float(logits.abs().max())), errs


def test_long_pad_runs_are_ill_conditioned_in_f32_in_both_packages(monkeypatch):
    """rwkv6's f32 forward is ill-conditioned on a long run of pad tokens,
    in the JAX package as in the port, which is why ``chip_smoke.py``'s
    phase 13 holds its most padded prompt to a float64 run rather than to
    the plain engine. Over the pads the wkv state nears kᵀv/(1 − w), about
    150 times one token's kᵀv; a real token's r then reads it with much
    cancellation, and the group norm scales what is left back to unit RMS,
    rounding errors included.

    Four layers of d 256 (heads of 64, as published), one prompt of 64
    tokens after 1,536 pads and one of 1,600 tokens. The JAX package's x64
    run (its ``jnp.float32`` casts pointed at float64 for the call) and the
    port's float64 run agree to 1e-9: one function. The JAX package's own f32
    forward lies more than 20× farther from its x64 run on the padded prompt
    than on the other, and the port's f32 forward no farther than twice the
    JAX package's. At rwkv6-3b's 32 layers of d 2,560 the same drift passes
    the LM tolerance (PERF.md §6)."""
    kw = dict(n_layers=4, segments=((("rwkv",), 4),), d_model=256, n_heads=4,
              n_kv_heads=4, d_head=64, d_ff=896, vocab=256)
    jcfg = dataclasses.replace(jcfgs.get_reduced_config(ARCH), **kw)
    tcfg = dataclasses.replace(tcfgs.get_reduced_config(ARCH), **kw)
    tp = ttr.init_params(tcfg, torch.Generator().manual_seed(0))
    layout = jax.tree.map(lambda t: t.numpy(), ttr.jax_layout(tcfg, tp))
    toks = np.random.default_rng(0).integers(1, 256, (2, 1600)).astype(np.int32)
    toks[1, :1536] = 0
    j32 = np.asarray(jtr.model_forward(jcfg, jax.tree.map(jnp.asarray, layout),
                                       {"tokens": jnp.asarray(toks)},
                                       compute_dtype=jnp.float32)[0])
    with jax.enable_x64(True):
        monkeypatch.setattr(jnp, "float32", jnp.float64)
        j64 = np.asarray(jtr.model_forward(
            jcfg, jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), layout),
            {"tokens": jnp.asarray(toks)}, compute_dtype=jnp.float64)[0])
        monkeypatch.undo()
    assert j64.dtype == np.float64
    t32, _ = ttr.model_forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                               compute_dtype=torch.float32)
    t64, _ = ttr.model_forward(tcfg, tree_map(lambda t: t.double(), tp),
                               {"tokens": torch.from_numpy(toks)}, backend="torch",
                               compute_dtype=torch.float64)
    scale = np.abs(j64).max()
    real = [slice(0, 1600), slice(1536, 1600)]  # the pads' own logits are not read

    def dist(a, row):
        return np.abs(np.asarray(a, np.float64)[row, real[row]] - j64[row, real[row]]).max()

    for row in (0, 1):
        assert dist(t64.numpy(), row) <= 1e-9 * scale
    assert max(dist(j32, 0), dist(t32.numpy(), 0)) <= 1e-4 * scale
    assert dist(j32, 1) > 20 * dist(j32, 0)
    assert dist(t32.numpy(), 1) <= 2 * dist(j32, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_engine_tokens_equal_jax(models, dtype):
    """Left-padded prompts: the pads pass through the state, as in the
    reference; the plain engine (the sequential wkv) gives the same
    tokens."""
    jcfg, tcfg, jp, tp = models
    prompts = [[3, 4, 5, 6, 7], [9, 10]]
    want = JaxEngine(jcfg, jp, max_seq=16, compute_dtype=getattr(jnp, dtype)).generate(
        prompts, 6)
    got = ServeEngine(tcfg, tp, max_seq=16, compute_dtype=getattr(torch, dtype),
                      device="cpu").generate(prompts, 6)
    plain = ServeEngine(tcfg, tp, max_seq=16, compute_dtype=getattr(torch, dtype),
                        device="cpu", backend="torch").generate(prompts, 6)
    if dtype == "float32":
        assert got == want == plain
    else:  # bf16 ties may flip a late token; the prompts and first tokens agree
        assert [g[:len(p) + 1] for g, p in zip(got, prompts)] == [
            w[:len(p) + 1] for w, p in zip(want, prompts)]


def test_params_round_trip_the_jax_layout(models):
    jcfg, tcfg, jp, tp = models
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


def test_checkpoints_cross_the_two_packages(models, tmp_path):
    """A JAX-package checkpoint of rwkv6 restores into the port and serves
    the reference's tokens; the port's own save restores into the JAX
    package's tree."""
    jcfg, tcfg, jp, _ = models
    jckpt.CheckpointManager(tmp_path / "jax").save(3, (jp,))
    template = ttr.jax_layout(tcfg, ttr.init_params(tcfg, torch.Generator().manual_seed(0)))
    (saved,), meta = CheckpointManager(tmp_path / "jax").restore((template,), device="cpu")
    assert meta["step"] == 3
    tp = ttr.params_from_jax(tcfg, saved, device="cpu")
    want = JaxEngine(jcfg, jp, max_seq=16, compute_dtype=jnp.float32).generate([[3, 4, 5]], 4)
    got = ServeEngine(tcfg, tp, max_seq=16, device="cpu").generate([[3, 4, 5]], 4)
    assert got == want
    CheckpointManager(tmp_path / "port").save(5, (ttr.jax_layout(tcfg, tp),))
    (back,), _ = jckpt.CheckpointManager(tmp_path / "port").restore((jp,))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_serve_entry_point_runs_rwkv(capsys):
    from repro_torch.launch import serve

    outs = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--max-new", "3"])
    assert [len(o) for o in outs] == [6, 5]
    assert "tok/s" in capsys.readouterr().out
