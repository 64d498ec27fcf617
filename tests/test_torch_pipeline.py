"""``repro_torch.sharding.pipeline``: the GPipe fill-drain schedule over 4
stage positions (``["cpu"] * 8`` as a 4 × 2 mesh) equals the JAX package's
sequential stack of ``tests/test_pipeline.py`` at 1e-5, and the bubble
model's three values."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.sharding.pipeline import bubble_fraction as jbubble  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.sharding import pipeline as tpipe  # noqa: E402


@pytest.mark.parametrize("n_micro", [1, 2, 4, 8])
def test_pipeline_matches_the_reference_sequential_stack(n_micro):
    mesh = Mesh(["cpu"] * 8, (4, 2), ("stage", "data"))
    s, d = 4, 16
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((s, d, d)) * 0.3).astype(np.float32)
    bs = (rng.standard_normal((s, d)) * 0.1).astype(np.float32)
    x = rng.standard_normal((8, d)).astype(np.float32)
    ref = jnp.asarray(x)
    for i in range(s):  # the reference test's oracle
        ref = jnp.tanh(ref @ jnp.asarray(ws[i]) + jnp.asarray(bs[i]))

    calls = []

    def stage_fn(p, h):
        calls.append(h.shape[0])
        w, b = p
        return torch.tanh(h @ w + b)

    out = tpipe.pipeline_apply(stage_fn, (torch.from_numpy(ws), torch.from_numpy(bs)),
                               torch.from_numpy(x), mesh=mesh, axis="stage",
                               n_micro=n_micro)
    assert out.shape == x.shape
    assert float(np.abs(out.numpy() - np.asarray(ref)).max()) < 1e-5
    # every stage runs every microbatch once, over M + S - 1 ticks
    assert len(calls) == s * n_micro and set(calls) == {8 // n_micro}


def test_pipeline_rejects_a_batch_the_microbatches_do_not_divide():
    mesh = Mesh(["cpu"] * 4, (4,), ("stage",))
    with pytest.raises(ValueError):
        tpipe.pipeline_apply(lambda p, h: h, torch.zeros(4, 1), torch.zeros(6, 2),
                             mesh=mesh, axis="stage", n_micro=4)


@pytest.mark.parametrize("stages,micro,want", [(4, 4, 3 / 7), (2, 30, 1 / 31), (1, 8, 0.0)])
def test_bubble_fraction(stages, micro, want):
    assert tpipe.bubble_fraction(stages, micro) == pytest.approx(want)
    assert tpipe.bubble_fraction(stages, micro) == jbubble(stages, micro)
