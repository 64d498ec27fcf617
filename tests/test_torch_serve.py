"""The port's ``ServeEngine`` against the JAX package's on the same weights:
greedy token lists must be equal, with ragged (left-padded) prompts and with
decode positions past ``max_seq`` (the cache's last slot is overwritten in
both packages). Also runs the port's serving CLI on the CPU."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfgs  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.transformer_serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.transformer_serve import ServeEngine  # noqa: E402


def _pair(variant, seed):
    jcfg = jcfgs.get_reduced_config("qwen2-0.5b")
    tcfg = tcfgs.get_reduced_config("qwen2-0.5b")
    if variant == "windowed":
        kw = dict(segments=((("local", "attn"), 2),), n_layers=4, window=8)
        jcfg, tcfg = dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = ttr.params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("variant,max_seq,max_new", [
    ("plain", 32, 8),      # fits the cache
    ("plain", 10, 8),      # plen 6 + 8 > 10: positions 10.. clamp to the last slot
    ("windowed", 24, 12),  # the local layers' ring wraps
])
def test_generate_matches_jax_engine(variant, max_seq, max_new):
    jcfg, tcfg, jp, tp = _pair(variant, seed=3)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, jcfg.vocab, n).tolist() for n in (6, 3, 1)]
    want = JaxEngine(jcfg, jp, max_seq=max_seq).generate(prompts, max_new_tokens=max_new)
    eng = ServeEngine(tcfg, tp, max_seq=max_seq, device="cpu")
    got = eng.generate(prompts, max_new_tokens=max_new)
    assert got == want
    assert [len(g) - len(p) for g, p in zip(got, prompts)] == [max_new] * 3
    assert eng.last_timing["decode_steps"] == max_new - 1


def test_teacher_forcing_reproduces_the_free_run():
    _, tcfg, _, tp = _pair("plain", seed=4)
    eng = ServeEngine(tcfg, tp, max_seq=16, device="cpu")
    prompts = [[5, 6, 7], [9]]
    toks, logits = eng.run(prompts, 5)
    assert logits.shape == (2, 5, tcfg.vocab)
    assert torch.equal(logits.argmax(-1), torch.tensor([t[-5:] for t in toks]))
    forced = torch.tensor([t[-5:] for t in toks])
    toks2, logits2 = eng.run(prompts, 5, forced=forced)
    assert toks2 == toks and torch.equal(logits2, logits)
    assert eng.run(prompts, 0)[0] == prompts


def test_serve_cli_runs_on_the_cpu(capsys):
    outs = tserve.main(["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
                        "--prompts", "1 2 3;7 8", "--max-new", "4"])
    assert [len(o) for o in outs] == [7, 6]
    assert "tok/s" in capsys.readouterr().out
    # the seed fixes the weights, so a second run gives the same tokens
    assert tserve.main(["--reduced", "--device", "cpu", "--prompts", "1 2 3;7 8",
                        "--max-new", "4"]) == outs
