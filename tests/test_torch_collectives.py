"""``repro_torch.sharding.collectives`` against the JAX package's: int8
gradient compression with error feedback (the same int8 values and scales:
both round half to even), 20 steps of error feedback, and gradient
accumulation over microbatches at the reference test's tolerance
(``tests/test_training.py::test_grad_accum_matches_full_batch``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.sharding import collectives as jcol  # noqa: E402
from repro_torch.sharding import collectives as tcol  # noqa: E402


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal(1000).astype(np.float32),
            "b": {"w": (rng.standard_normal((7, 5)) * 3).astype(np.float32)},
            # ties at .5 steps of the scale: half to even in both packages
            "c": (np.arange(-254, 255, dtype=np.float32) / 2.0)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_grads_equals_the_reference(seed):
    g = _grads(seed)
    jq, js, je = jcol.compress_grads(jax.tree.map(jnp.asarray, g),
                                     jcol.init_error_feedback(jax.tree.map(jnp.asarray, g)))
    tg = {"a": torch.from_numpy(g["a"]), "b": {"w": torch.from_numpy(g["b"]["w"])},
          "c": torch.from_numpy(g["c"])}
    tq, ts, te = tcol.compress_grads(tg, tcol.init_error_feedback(tg))
    for key in ("a", "c"):
        assert tq[key].dtype == torch.int8
        assert np.array_equal(tq[key].numpy(), np.asarray(jq[key]))
        assert float(ts[key]) == float(js[key])
        np.testing.assert_array_equal(te[key].numpy(), np.asarray(je[key]))
    assert np.array_equal(tq["b"]["w"].numpy(), np.asarray(jq["b"]["w"]))
    assert float(ts["b"]["w"]) == float(js["b"]["w"])
    deq = tcol.decompress_grads(tq, ts)
    want = jcol.decompress_grads(jq, js)
    np.testing.assert_array_equal(deq["a"].numpy(), np.asarray(want["a"]))


def test_error_feedback_over_20_steps_follows_the_reference():
    g = _grads(0)
    jg = {"a": jnp.asarray(g["a"])}
    tg = {"a": torch.from_numpy(g["a"])}
    jef, tef = jcol.init_error_feedback(jg), tcol.init_error_feedback(tg)
    jtot, ttot = np.zeros(1000, np.float32), torch.zeros(1000)
    for _ in range(20):
        jq, js, jef = jcol.compress_grads(jg, jef)
        tq, ts, tef = tcol.compress_grads(tg, tef)
        assert np.array_equal(tq["a"].numpy(), np.asarray(jq["a"]))
        np.testing.assert_allclose(tef["a"].numpy(), np.asarray(jef["a"]), atol=1e-6)
        jtot = jtot + np.asarray(jcol.decompress_grads(jq, js)["a"])
        ttot = ttot + tcol.decompress_grads(tq, ts)["a"]
    np.testing.assert_allclose(ttot.numpy(), jtot, atol=1e-5)
    # the reference test's own claim: the mean converges on the gradient
    np.testing.assert_allclose(ttot.numpy() / 20, g["a"], atol=1e-2)


def test_grad_accum_matches_full_batch_and_the_reference():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((4, 2)).astype(np.float32)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    y = rng.standard_normal((8, 2)).astype(np.float32)

    def tloss(params, batch):
        return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

    def jloss(params, batch):
        return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

    tparams = {"w": torch.from_numpy(w)}
    tbatch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    wt = tparams["w"].clone().requires_grad_(True)
    (g_full,) = torch.autograd.grad(tloss({"w": wt}, tbatch), [wt])
    g_acc, loss = tcol.grad_accum_microbatches(tloss, tparams, tbatch, 4)
    np.testing.assert_allclose(g_acc["w"].numpy(), g_full.numpy(), atol=1e-5)
    jg, jl = jcol.grad_accum_microbatches(jloss, {"w": jnp.asarray(w)},
                                          {"x": jnp.asarray(x), "y": jnp.asarray(y)}, 4)
    np.testing.assert_allclose(g_acc["w"].numpy(), np.asarray(jg["w"]), atol=1e-5)
    assert abs(float(loss) - float(jl)) <= 1e-6 * max(1.0, abs(float(jl)))
