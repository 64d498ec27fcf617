"""LM training on the port: ``launch/steps`` (``make_train_step`` and the
prefill/decode wrappers), ``cfg.remat`` and ``launch/train``, against the
JAX package on the CPU (the flash kernel's backward and the specs are in
``test_torch_flash_grad.py``).

The reference's own ``make_train_step`` fails on jax 0.9 (its mesh hints;
``tests/test_training.py::test_lm_loss_decreases``), so the oracle of a
train step is its pieces composed without a mesh: ``jax.value_and_grad`` of
``model_forward`` + ``steps.cross_entropy`` + 0.01·aux, then
``optimizer.adamw_update``; the port's side is ``value_and_grad`` and
``adamw_update``, the two pieces ``make_train_step`` composes, in f32.
Tolerances (f32 compute, so that no MoE near-tie flips a route): the loss
at 1e-5 of its value, every grad leaf at 1e-4 of the leaf's largest entry
(f32 arithmetic in another order through a few layers), and the
parameters after AdamW where the grad tolerance leaves
them: AdamW's first step moves p by lr·(ĝ/(|ĝ|+ε) + wd·p) with ĝ the
clipped grad, so each entry is held to that step's range over ĝ's tolerance
interval (a grad within its tolerance of 0 may move its entry by up to
2·lr), plus f32 rounding."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfgs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.tree import flatten_with_paths, tree_map  # noqa: E402

FAMILIES = ["qwen2-0.5b", "granite-moe-3b-a800m", "rwkv6-3b", "recurrentgemma-2b",
            "whisper-tiny"]
LOSS_REL, GRAD_REL = 1e-5, 1e-4


def _flat_np(tree):
    return {k: np.asarray(v.detach().float() if torch.is_tensor(v) else v)
            for k, v in flatten_with_paths(tree).items()}


# ---------------------------------------------------------------------------
# one train step against the reference's pieces
# ---------------------------------------------------------------------------


def _reduced(arch):
    return jcfgs.get_reduced_config(arch), tcfgs.get_reduced_config(arch)


def _batch(cfg, seed, b=2, s=12):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.encoder is not None:  # as the reference's launch/train feeds it
        batch["source_embed"] = np.zeros((b, cfg.encoder.max_source, cfg.d_model),
                                         np.float32)
    return batch


def _reference_step(jcfg, jparams, batch, opt_cfg):
    def loss_fn(params, b):
        logits, aux = jtr.model_forward(jcfg, params, b, compute_dtype=jnp.float32)
        return jsteps.cross_entropy(logits, b["labels"]) + 0.01 * aux

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    new, _, metrics = jopt.adamw_update(opt_cfg, grads, jopt.adamw_init(jparams),
                                        param_dtype=jnp.float32)
    return float(loss), grads, new, metrics


def _first_step_range(g, delta, lr, eps):
    """The largest change of AdamW's first step lr·ĝ/(|ĝ|+ε) over ĝ within
    ``delta`` of ``g`` (the step is monotone in ĝ)."""
    def step(x):
        return lr * x / (np.abs(x) + eps)
    return np.maximum(np.abs(step(g + delta) - step(g)), np.abs(step(g - delta) - step(g)))


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_the_reference_pieces(arch):
    jcfg, tcfg = _reduced(arch)
    tparams = ttr.init_params(tcfg, torch.Generator().manual_seed(1))
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), ttr.jax_layout(tcfg, tparams))
    batch = _batch(jcfg, 2)
    kw = dict(lr=1e-2, warmup_steps=1)
    jloss, jgrads, jnew, jmetrics = _reference_step(jcfg, jparams, batch,
                                                    jopt.AdamWConfig(**kw))

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = tsteps.value_and_grad(tcfg, tparams, tb, compute_dtype=torch.float32)
    assert abs(float(loss) - jloss) <= LOSS_REL * abs(jloss)
    want_g = _flat_np(jax.tree.map(np.asarray, jgrads))
    got_g = _flat_np(ttr.jax_layout(tcfg, grads))
    assert got_g.keys() == want_g.keys()
    for key, w in want_g.items():
        assert got_g[key].shape == w.shape, key
        np.testing.assert_allclose(got_g[key], w, atol=GRAD_REL * np.abs(w).max(),
                                   rtol=0, err_msg=key)

    opt_cfg = topt.AdamWConfig(**kw)
    new, state, metrics = topt.adamw_update(opt_cfg, grads, topt.adamw_init(tparams),
                                            param_dtype=torch.float32)
    gnorm = float(jmetrics["grad_norm"])
    assert abs(float(metrics["grad_norm"]) - gnorm) <= 1e-5 * gnorm
    assert int(state["count"]) == 1
    clip = min(1.0, opt_cfg.grad_clip / (gnorm + 1e-9))
    got_p = _flat_np(ttr.jax_layout(tcfg, new))
    for key, w in _flat_np(jax.tree.map(np.asarray, jnew)).items():
        g = want_g[key]
        delta = GRAD_REL * np.abs(g).max() + 1e-5 * np.abs(g)  # + the clip's own error
        tol = _first_step_range(clip * g, clip * delta, opt_cfg.lr, opt_cfg.eps)
        err = np.abs(got_p[key] - w)
        assert (err <= tol + 1e-6 * np.maximum(1.0, np.abs(w))).all(), (key, err.max())


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-2b", "rwkv6-3b"])
def test_remat_gives_the_grads_of_no_remat(arch, monkeypatch):
    """With ``cfg.remat`` each layer's forward runs twice a step (once in
    the backward), and the grads are those of the plain graph."""
    _, tcfg = _reduced(arch)
    params = ttr.init_params(tcfg, torch.Generator().manual_seed(2))
    tb = {k: torch.from_numpy(v) for k, v in _batch(tcfg, 3).items()}
    calls = []
    real = ttr._layer

    def counted(*args, **kwargs):
        calls.append(args[1])
        return real(*args, **kwargs)

    monkeypatch.setattr(ttr, "_layer", counted)
    plain = tsteps.value_and_grad(tcfg, params, tb, compute_dtype=torch.float32)
    assert len(calls) == tcfg.n_layers
    calls.clear()
    remat = tsteps.value_and_grad(dataclasses.replace(tcfg, remat=True), params, tb,
                                  compute_dtype=torch.float32)
    assert len(calls) == 2 * tcfg.n_layers
    assert float(plain[0]) == float(remat[0])
    for a, b in zip(flatten_with_paths(plain[1]).values(),
                    flatten_with_paths(remat[1]).values()):
        torch.testing.assert_close(a, b, atol=1e-6 * max(1.0, float(a.abs().max())), rtol=0)


def test_train_step_checks_its_batch_and_keeps_bf16_params():
    _, tcfg = _reduced("qwen2-0.5b")
    specs = {k: torch.empty((2, 12), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    step, (param_specs, opt_specs) = tsteps.make_train_step(tcfg, "cpu", specs)
    params = ttr.init_params(tcfg, torch.Generator().manual_seed(0))
    for spec, p in zip(flatten_with_paths(param_specs).values(),
                       flatten_with_paths(params).values()):
        assert spec.device.type == "meta" and spec.dtype == torch.bfloat16
        assert spec.shape == p.shape
    assert opt_specs["count"].dtype == torch.int32
    assert all(t.dtype == torch.float32 for t in flatten_with_paths(opt_specs["m"]).values())
    bf16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    new, state, metrics = step(bf16, topt.adamw_init(params), _batch(tcfg, 4))
    assert all(t.dtype == torch.bfloat16 for t in flatten_with_paths(new).values())
    assert np.isfinite(float(metrics["loss"])) and int(state["count"]) == 1
    with pytest.raises(ValueError, match="was made for"):
        step(bf16, state, _batch(tcfg, 5, s=10))


def test_prefill_and_decode_steps_wrap_the_model():
    _, tcfg = _reduced("qwen2-0.5b")
    params = ttr.init_params(tcfg, torch.Generator().manual_seed(5))
    toks = torch.from_numpy(_batch(tcfg, 6)["tokens"])
    prefill, (pspecs,) = tsteps.make_prefill_step(tcfg, "cpu", max_seq=16)
    decode, (_, cache_specs) = tsteps.make_decode_step(tcfg, "cpu", batch=2, max_seq=16)
    logits, cache = prefill(params, {"tokens": toks})
    want, want_cache = ttr.prefill(tcfg, params, {"tokens": toks}, max_seq=16)
    assert torch.equal(logits, want)
    assert [c["k"].shape for c in cache] == [c["k"].shape for c in cache_specs]
    step, _ = decode(params, cache, toks[:, -1], 12)
    gold, _ = ttr.decode_step(tcfg, params, want_cache, toks[:, -1], 12)
    assert torch.equal(step, gold)
    assert all(t.device.type == "meta" for t in flatten_with_paths(pspecs).values())


# ---------------------------------------------------------------------------
# launch/train
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--arch", "qwen2-0.5b", "--reduced", "--batch", "4", "--seq", "32",
              "--lr", "2e-3", "--device", "cpu", "--log-every", "100"]


def test_launch_train_lowers_the_loss(capsys):
    """The reference test's own assertion (``test_lm_loss_decreases``),
    which the reference fails here only on jax 0.9's mesh."""
    losses = ttrain.main(TRAIN_ARGS + ["--steps", "25"])
    assert len(losses) == 25
    assert losses[-1] < losses[0] - 0.05
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "gnorm" in out and "first-loss" in out


def test_launch_train_resumes_bit_for_bit(tmp_path, capsys):
    """A run that stops right after its step-10 checkpoint (as a kill
    there would) and is rerun resumes from it; its losses and final
    checkpoint equal an uninterrupted run's bit for bit. Keep-2 leaves the
    two newest checkpoints, which the JAX package's manager also reads."""
    whole = ttrain.main(TRAIN_ARGS + ["--steps", "25", "--ckpt-dir", str(tmp_path / "a"),
                                   "--ckpt-every", "10"])
    first = ttrain.main(TRAIN_ARGS + ["--steps", "10", "--ckpt-dir", str(tmp_path / "b"),
                                   "--ckpt-every", "10"])
    rest = ttrain.main(TRAIN_ARGS + ["--steps", "25", "--ckpt-dir", str(tmp_path / "b"),
                                  "--ckpt-every", "10"])
    assert "resumed from step 10" in capsys.readouterr().out
    assert first == whole[:10] and rest == whole[10:]
    for d in ("a", "b"):
        assert sorted(p.name for p in (tmp_path / d).glob("step_*")) == [
            "step_000000020", "step_000000025"]
    a = np.load(tmp_path / "a" / "step_000000025" / "arrays.npz")
    b = np.load(tmp_path / "b" / "step_000000025" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key])
    from repro.training import checkpoint as jckpt

    jcfg, _ = _reduced("qwen2-0.5b")
    jp = jtr.param_specs(jcfg)
    template = jax.tree.map(lambda s: jnp.zeros(s.shape, jnp.bfloat16), jp)
    (params, opt), meta = jckpt.CheckpointManager(tmp_path / "a").restore(
        (template, jopt.adamw_init(jax.tree.map(lambda s: jnp.zeros(s.shape), jp))))
    assert meta["step"] == 25 and int(opt["count"]) == 25
    assert meta["extra"]["pipeline"]["step"] == 25
