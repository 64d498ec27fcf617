"""Parity of the port's encoder-decoder path (``enc`` and ``xattn`` layers,
``ServeEngine(source_embed=)``) with the JAX package on reduced
whisper-tiny (2 encoder and 2 decoder layers, ``max_source`` 16), on the
same weights (``params_from_jax``) and numpy frame embeddings.

Logits, prefill and every decode step are held at 2e-3·max(1, |gold|max),
the reference's decode-vs-forward tolerance; caches at 1e-4. The
reference's decode attends to the cache's zero-padded encoder keys with no
mask, so with fewer frames than ``max_source`` its decode departs from its
own forward; the port must give the reference's numbers there too. In bf16
the logits are held within 3× the reference's own bf16 error against its
f32 logits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfgs  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.transformer_serve import ServeEngine as JaxEngine  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.transformer_serve import ServeEngine  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402

ARCH = "whisper-tiny"
LM_TOL = 2e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _lm_close(got, want):
    want = np.asarray(want)
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, atol=LM_TOL * max(1.0, np.abs(want).max()),
                               rtol=0)


def _models(seed=0):
    jcfg, tcfg = jcfgs.get_reduced_config(ARCH), tcfgs.get_reduced_config(ARCH)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, ttr.params_from_jax(tcfg, _np(jp), device="cpu")


def _batch(cfg, seed, b=2, s=12, frames=None):
    rng = np.random.default_rng(seed)
    frames = frames or cfg.encoder.max_source
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "source_embed": rng.standard_normal((b, frames, cfg.d_model)).astype(
                np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _cut(batch, n):
    return dict(batch, tokens=batch["tokens"][:, :n])


def test_params_carry_the_encoder():
    jcfg, tcfg, jp, tp = _models()
    assert len(tp["encoder"]) == jcfg.encoder.n_layers == 2
    assert set(tp["encoder"][0]) == {"norm1", "attn", "norm2", "mlp"}
    assert set(tp["layers"][0]) == {"norm1", "attn", "norm2", "xnorm", "xattn", "norm3",
                                    "mlp"}
    np.testing.assert_array_equal(tp["encoder"][1]["attn"]["wq"].numpy(),
                                  np.asarray(jp["encoder"]["l0"]["attn"]["wq"][1]))
    np.testing.assert_array_equal(tp["enc_norm"]["b"].numpy(),
                                  np.asarray(jp["enc_norm"]["b"]))
    tinit = ttr.init_params(tcfg, torch.Generator().manual_seed(0))
    assert tinit.keys() == tp.keys()
    assert [p.keys() for p in tinit["encoder"]] == [p.keys() for p in tp["encoder"]]


def test_params_round_trip_the_jax_layout():
    jcfg, tcfg, jp, tp = _models(1)
    back = ttr.jax_layout(tcfg, tp)
    assert set(back) == set(jp) and set(back["encoder"]) == {"l0"}
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


def test_checkpoints_cross_the_two_packages(tmp_path):
    """A JAX-package checkpoint of whisper (its stacked ``encoder/l0``
    included) restores into the port, and the port's own save restores
    into the JAX package's tree."""
    jcfg, tcfg, jp, _ = _models(9)
    jckpt.CheckpointManager(tmp_path / "jax").save(2, (jp,))
    template = ttr.jax_layout(tcfg, ttr.init_params(tcfg, torch.Generator().manual_seed(0)))
    (saved,), meta = CheckpointManager(tmp_path / "jax").restore((template,), device="cpu")
    assert meta["step"] == 2
    tp = ttr.params_from_jax(tcfg, saved, device="cpu")
    src = _batch(jcfg, 10)
    want = JaxEngine(jcfg, jp, max_seq=16).generate([[3, 4, 5]], 4,
                                                    source_embed=src["source_embed"][:1])
    got = ServeEngine(tcfg, tp, max_seq=16, device="cpu").generate(
        [[3, 4, 5]], 4, source_embed=src["source_embed"][:1])
    assert got == want
    CheckpointManager(tmp_path / "port").save(5, (ttr.jax_layout(tcfg, tp),))
    (back,), _ = jckpt.CheckpointManager(tmp_path / "port").restore((jp,))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_count_params_equals_the_reference():
    assert (ttr.count_params(tcfgs.get_config(ARCH))
            == jtr.count_params(jcfgs.get_config(ARCH)) == 36_451_200)
    assert (ttr.count_params(tcfgs.get_reduced_config(ARCH))
            == jtr.count_params(jcfgs.get_reduced_config(ARCH)))


@pytest.mark.parametrize("frames", [16, 10, 1])
def test_model_forward_matches_jax(frames):
    jcfg, tcfg, jp, tp = _models(2)
    batch = _batch(jcfg, frames, frames=frames)
    jl, _ = jtr.model_forward(jcfg, jp, _jax(batch), compute_dtype=jnp.float32)
    tl, aux = ttr.model_forward(tcfg, tp, _torch(batch), compute_dtype=torch.float32)
    assert tl.shape == (2, 12, tcfg.vocab) and float(aux) == 0.0
    _lm_close(tl, jl)


def test_model_forward_matches_jax_in_bf16():
    jcfg, tcfg, jp, tp = _models(3)
    batch = _batch(jcfg, 3)
    j16 = np.asarray(jtr.model_forward(jcfg, jp, _jax(batch))[0].astype(jnp.float32))
    j32 = np.asarray(jtr.model_forward(jcfg, jp, _jax(batch), compute_dtype=jnp.float32)[0])
    t16, _ = ttr.model_forward(tcfg, tp, _torch(batch))
    assert t16.dtype == torch.bfloat16
    own = np.abs(j16 - j32).max()
    assert 0 < np.abs(t16.float().numpy() - j16).max() <= 3 * own


def test_source_embed_is_cast_to_the_compute_dtype():
    jcfg, tcfg, _, tp = _models()
    batch = _torch(_batch(jcfg, 4))
    f64 = dict(batch, source_embed=batch["source_embed"].double())
    a, _ = ttr.model_forward(tcfg, tp, batch, compute_dtype=torch.float32)
    b, _ = ttr.model_forward(tcfg, tp, f64, compute_dtype=torch.float32)
    assert torch.equal(a, b)


@pytest.mark.parametrize("frames,pre", [(16, 9), (10, 9), (10, 4), (3, 6)])
def test_prefill_and_decode_match_jax(frames, pre):
    """Every decode step and the caches, also with fewer frames than
    ``max_source`` (the zero-padded cross keys take part in decode's
    softmax, as in the reference)."""
    jcfg, tcfg, jp, tp = _models(4)
    batch = _batch(jcfg, frames + pre, frames=frames)
    s = batch["tokens"].shape[1]
    jl, jc = jtr.prefill(jcfg, jp, _jax(_cut(batch, pre)), max_seq=s,
                         compute_dtype=jnp.float32)
    tl, tc = ttr.prefill(tcfg, tp, _torch(_cut(batch, pre)), max_seq=s,
                         compute_dtype=torch.float32)
    _lm_close(tl, jl)
    toks = batch["tokens"]
    for t in range(pre, s):
        jl, jc = jtr.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, t]), jnp.int32(t),
                                 compute_dtype=jnp.float32)
        tl, tc = ttr.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, t]), t,
                                 compute_dtype=torch.float32)
        _lm_close(tl, jl)
    for li, got in enumerate(tc):
        want = {k: np.asarray(v[li]) for k, v in jc["seg0"]["l0"].items()}
        assert got.keys() == want.keys() == {"k", "v", "xk", "xv"}
        for k in want:
            assert tuple(got[k].shape) == want[k].shape
            np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-4, rtol=0)
        assert not got["xk"][:, frames:].any() and not got["xv"][:, frames:].any()


def test_short_source_decode_departs_from_forward_as_the_reference_does():
    """Reference fact: with 10 of 16 frames the decode attends to 6 zero
    keys, and departs from the forward pass (which sees 10 keys) by far more
    than the tolerance; with all 16 frames it does not. The port's decode
    equals the reference's decode in both cases."""
    jcfg, tcfg, jp, tp = _models(5)
    gaps = {}
    for frames in (10, 16):
        batch = _batch(jcfg, 50, frames=frames)
        fwd, _ = ttr.model_forward(tcfg, tp, _torch(batch), compute_dtype=torch.float32)
        jfwd, _ = jtr.model_forward(jcfg, jp, _jax(batch), compute_dtype=jnp.float32)
        _lm_close(fwd, jfwd)
        _, tc = ttr.prefill(tcfg, tp, _torch(_cut(batch, 8)), max_seq=12,
                            compute_dtype=torch.float32)
        _, jc = jtr.prefill(jcfg, jp, _jax(_cut(batch, 8)), max_seq=12,
                            compute_dtype=jnp.float32)
        gap = 0.0
        for t in range(8, 12):
            tok = batch["tokens"][:, t]
            tl, tc = ttr.decode_step(tcfg, tp, tc, torch.from_numpy(tok), t,
                                     compute_dtype=torch.float32)
            jl, jc = jtr.decode_step(jcfg, jp, jc, jnp.asarray(tok), jnp.int32(t),
                                     compute_dtype=jnp.float32)
            _lm_close(tl, jl)
            gap = max(gap, float((tl[:, 0] - fwd[:, t]).abs().max()))
        gaps[frames] = gap
    assert gaps[16] < LM_TOL and gaps[10] > 10 * LM_TOL, gaps


def test_decode_matches_forward_on_port_weights():
    _, tcfg, _, _ = _models()
    tp = ttr.init_params(tcfg, torch.Generator().manual_seed(6))
    batch = _torch(_batch(tcfg, 6, s=14))
    logits, _ = ttr.model_forward(tcfg, tp, batch, compute_dtype=torch.float32)
    last, cache = ttr.prefill(tcfg, tp, _cut(batch, 5), max_seq=14,
                              compute_dtype=torch.float32)
    errs = [float((last[:, 0] - logits[:, 4]).abs().max())]
    for t in range(5, 14):
        step, cache = ttr.decode_step(tcfg, tp, cache, batch["tokens"][:, t], t,
                                      compute_dtype=torch.float32)
        errs.append(float((step[:, 0] - logits[:, t]).abs().max()))
    assert max(errs) < LM_TOL, errs


def test_decode_backend_selects_the_cross_attention():
    """``decode_step(backend=)`` reaches ``ops.attention``: the chunked
    oracle and the plain reference give the same step."""
    jcfg, tcfg, _, tp = _models(7)
    batch = _torch(_batch(jcfg, 7))
    _, cache = ttr.prefill(tcfg, tp, _cut(batch, 6), max_seq=12,
                           compute_dtype=torch.float32)
    snap = [{k: v.clone() for k, v in c.items()} for c in cache]
    a, _ = ttr.decode_step(tcfg, tp, cache, batch["tokens"][:, 6], 6, backend="torch",
                           compute_dtype=torch.float32)
    b, _ = ttr.decode_step(tcfg, tp, snap, batch["tokens"][:, 6], 6,
                           compute_dtype=torch.float32)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown backend"):
        ttr.decode_step(tcfg, tp, snap, batch["tokens"][:, 7], 7, backend="tpu",
                        compute_dtype=torch.float32)


def test_prefill_refuses_more_frames_than_max_source():
    jcfg, tcfg, _, tp = _models()
    batch = _torch(_batch(jcfg, 8, frames=17))
    with pytest.raises(ValueError, match="max_source"):
        ttr.prefill(tcfg, tp, batch, max_seq=16, compute_dtype=torch.float32)


@pytest.mark.parametrize("frames", [16, 10])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_engine_tokens_equal_jax(frames, dtype):
    jcfg, tcfg, jp, tp = _models(8)
    src = _batch(jcfg, 9, frames=frames)["source_embed"]
    prompts = [[3, 4, 5, 6], [7, 8]]
    want = JaxEngine(jcfg, jp, max_seq=16, compute_dtype=getattr(jnp, dtype)).generate(
        prompts, 6, source_embed=src)
    eng = ServeEngine(tcfg, tp, max_seq=16, compute_dtype=getattr(torch, dtype),
                      device="cpu")
    got = eng.generate(prompts, 6, source_embed=src)
    if dtype == "float32":
        assert got == want
    else:  # bf16 ties may flip a late token; the prompts and first tokens agree
        assert [g[:len(p) + 1] for g, p in zip(got, prompts)] == [
            w[:len(p) + 1] for w, p in zip(want, prompts)]
    toks, logits = eng.run(prompts, 6, source_embed=torch.from_numpy(src))
    assert toks == got and logits.shape == (2, 6, tcfg.vocab)


def test_serve_engine_needs_source_embed():
    _, tcfg, _, tp = _models()
    eng = ServeEngine(tcfg, tp, max_seq=16, device="cpu")
    with pytest.raises(ValueError, match="source_embed"):
        eng.generate([[1, 2]], 2)


def test_decoder_only_engine_ignores_source_embed():
    cfg = tcfgs.get_reduced_config("qwen2-0.5b")
    tp = ttr.init_params(cfg, torch.Generator().manual_seed(0))
    eng = ServeEngine(cfg, tp, max_seq=16, device="cpu")
    assert eng.generate([[1, 2]], 3) == eng.generate(
        [[1, 2]], 3, source_embed=np.zeros((1, 4, cfg.d_model), np.float32))
