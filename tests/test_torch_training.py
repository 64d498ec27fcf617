"""The port's AdamW (``repro_torch.training.optimizer``) against the JAX
package's: its own tests re-run on the port, and ten updates side by side on
the same gradients, with f32 and with bf16 working parameters."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.training import optimizer as jopt  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import tree as ttree  # noqa: E402

#: the master weights and moments: float32 arithmetic in another order
REL = 1e-6


def test_adamw_decreases_quadratic():
    cfg = topt.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=100,
                           weight_decay=0.0, grad_clip=None)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = topt.adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * state["master"]["w"]}  # d/dw w^2
        params, state, _ = topt.adamw_update(cfg, grads, state,
                                             param_dtype=torch.float32)
    assert float(state["master"]["w"].abs().max()) < 0.15


def test_lr_schedule_shape():
    cfg = topt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                           min_lr_ratio=0.1)
    lrs = [float(topt.lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in [0, 5, 10, 55, 100]]
    assert lrs[1] < lrs[2]            # warmup rising
    assert lrs[2] >= lrs[3] >= lrs[4]  # cosine falling
    assert abs(lrs[4] - 0.1) < 1e-6    # floor


@pytest.mark.parametrize("step", [0, 1, 5, 10, 37, 100, 250])
def test_lr_schedule_matches_reference(step):
    cfg = topt.AdamWConfig(lr=0.3, warmup_steps=10, total_steps=100)
    want = float(jopt.lr_schedule(cfg, jnp.int32(step)))
    got = float(topt.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32)))
    assert got == pytest.approx(want, rel=REL, abs=1e-12)


def _params(rng):
    return {"w0": rng.standard_normal((6, 5)).astype(np.float32),
            "w1": rng.standard_normal(7).astype(np.float32),
            "blk": {"a": rng.standard_normal((3, 2)).astype(np.float32)}}


def _close(got: torch.Tensor, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=REL,
                               atol=REL * max(1e-3, float(np.abs(want).max())))


@pytest.mark.parametrize("grad_clip,weight_decay", [(1.0, 0.1), (None, 0.0),
                                                    (0.05, 0.01)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype, grad_clip, weight_decay):
    rng = np.random.default_rng(11)
    np_params = _params(rng)
    cfg = topt.AdamWConfig(lr=0.05, warmup_steps=3, total_steps=20,
                           grad_clip=grad_clip, weight_decay=weight_decay)
    jstate = jopt.adamw_init(ttree.tree_map(jnp.asarray, np_params))
    tstate = topt.adamw_init(ttree.tree_map(torch.from_numpy, np_params))
    assert tstate["count"].dtype == torch.int32 and tstate["count"].dim() == 0
    for _ in range(10):
        grads = ttree.tree_map(
            lambda p: (rng.standard_normal(p.shape) * 3).astype(np.float32), np_params)
        jp, jstate, jm = jopt.adamw_update(cfg, ttree.tree_map(jnp.asarray, grads),
                                           jstate, param_dtype=getattr(jnp, dtype))
        tp, tstate, tm = topt.adamw_update(cfg, ttree.tree_map(torch.from_numpy, grads),
                                           tstate, param_dtype=getattr(torch, dtype))
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=REL)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=REL)
        assert int(tstate["count"]) == int(jstate["count"])
        for part in ("master", "m", "v"):
            ttree.tree_map(_close, tstate[part], jstate[part])
        for t, j in zip(ttree.leaves(tp), ttree.leaves(jp)):
            assert t.dtype == getattr(torch, dtype)
            if dtype == "bfloat16":  # the cast of equal masters: equal bits
                assert np.array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(j).view(np.int16))
            else:
                _close(t, j)


def test_adamw_update_leaves_its_inputs_alone():
    params = {"w": torch.tensor([1.0, 2.0])}
    state = topt.adamw_init(params)
    grads = {"w": torch.tensor([0.5, -0.5])}
    before = ttree.tree_map(torch.clone, (params, state, grads))
    new_params, new_state, _ = topt.adamw_update(topt.AdamWConfig(), grads, state,
                                                 param_dtype=torch.float32)
    for a, b in zip(ttree.leaves((params, state, grads)), ttree.leaves(before)):
        assert torch.equal(a, b)
    assert new_params["w"].data_ptr() != new_state["master"]["w"].data_ptr()
    assert not new_params["w"].requires_grad


def test_tree_paths_are_the_reference_checkpoint_keys():
    from repro.training.checkpoint import _flatten

    tree = ({"w1": 1, "w0": [2, 3], "b": {"z": 4, "a": 5}}, {"count": 6})
    assert list(ttree.flatten_with_paths(tree)) == list(_flatten(tree))
    assert ttree.leaves(tree) == list(_flatten(tree).values())
