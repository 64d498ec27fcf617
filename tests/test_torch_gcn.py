"""The port's GCN against ``repro.core.gcn`` with one weight set handed to
both (``params_from_jax``): the COO forward, the executor forward, the
batched serving forward, the loss and accuracy, and the ``nn.Module``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import gcn as jgcn  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.graphs import synth as jsynth  # noqa: E402
from repro.tuning import registry as jreg  # noqa: E402
from repro_torch.core import gcn as tgcn  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.graphs import synth as tsynth  # noqa: E402
from repro_torch.tuning import registry as treg  # noqa: E402

TOL = 1e-4


@pytest.fixture(scope="module")
def data():
    t = tsynth.make_dataset("cora", seed=0, scale=4, device="cpu")
    j = jsynth.make_dataset("cora", seed=0, scale=4)
    cfg = jgcn.GCNConfig(j.num_features, j.hidden, j.num_classes)
    jparams = jgcn.init_params(cfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    return t, j, cfg, jparams, tgcn.params_from_jax(np_params, "cpu")


@pytest.fixture(autouse=True)
def _fresh_caches():
    treg.clear_caches()
    jreg.clear_caches()
    yield
    treg.clear_caches()
    jreg.clear_caches()


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=TOL * max(1.0, np.abs(want).max()))


def test_params_from_jax_keeps_layout(data):
    _, j, cfg, jparams, tparams = data
    assert list(tparams) == ["w0", "w1"]
    for k in jparams:
        assert np.array_equal(tparams[k].numpy(), np.asarray(jparams[k]))
        assert tparams[k].dtype == torch.float32


def test_forward_coo_matches_reference(data):
    t, j, _, jparams, tparams = data
    x = j.features
    _close(tgcn.forward(tparams, t.adj, torch.from_numpy(x)),
           jgcn.forward(jparams, j.adj, jnp.asarray(x)))


@pytest.mark.parametrize("pin_schedule", [False, True])
def test_forward_awb_matches_reference(data, pin_schedule):
    t, j, _, jparams, tparams = data
    x = j.features
    kw = {}
    jkw = {}
    if pin_schedule:
        kw["sched"] = tsched.build_balanced_schedule(t.adj, 32, 16, evil_threshold=8)
        jkw["sched"] = jsched.build_balanced_schedule(j.adj, 32, 16, evil_threshold=8)
    got = tgcn.forward_awb(tparams, t.adj, torch.from_numpy(x), device="cpu", **kw)
    _close(got, jgcn.forward_awb(jparams, j.adj, jnp.asarray(x), **jkw))
    _close(got, jgcn.forward(jparams, j.adj, jnp.asarray(x)))


def test_serving_batch_matches_vmapped_engine_forward(data):
    t, j, _, jparams, tparams = data
    rng = np.random.default_rng(1)
    x = j.features
    xs = np.stack([x * (rng.random(x.shape) < 0.9) for _ in range(4)])
    xs = xs.astype(np.float32)
    tex = treg.get_executor(t.adj, device="cpu")
    jex = jreg.get_executor(j.adj)
    want = jax.vmap(jex._forward_impl, in_axes=(None, 0))(jparams, jnp.asarray(xs))
    _close(tex.forward_batch(tparams, torch.from_numpy(xs)), want)


def test_loss_and_accuracy_match_reference(data):
    t, j, _, jparams, tparams = data
    x = j.features
    labels = j.labels
    mask = (np.arange(t.num_nodes) % 3 == 0).astype(np.float32)
    _close(tgcn.loss_fn(tparams, t.adj, torch.from_numpy(x), torch.from_numpy(labels)),
           jgcn.loss_fn(jparams, j.adj, jnp.asarray(x), jnp.asarray(labels)))
    _close(tgcn.loss_fn(tparams, t.adj, torch.from_numpy(x), torch.from_numpy(labels),
                        mask=torch.from_numpy(mask)),
           jgcn.loss_fn(jparams, j.adj, jnp.asarray(x), jnp.asarray(labels),
                        mask=jnp.asarray(mask)))
    assert float(tgcn.accuracy(tparams, t.adj, torch.from_numpy(x),
                               torch.from_numpy(labels))) == pytest.approx(
        float(jgcn.accuracy(jparams, j.adj, jnp.asarray(x), jnp.asarray(labels))))


def test_module_runs_single_and_batched_requests(data):
    t, j, _, jparams, tparams = data
    cfg = tgcn.GCNConfig(t.num_features, t.hidden, t.num_classes)
    ex = treg.get_executor(t.adj, device="cpu")
    model = tgcn.GCN(cfg, ex, params=tparams)
    x = torch.from_numpy(j.features)
    assert sorted(n for n, _ in model.named_parameters()) == ["w0", "w1"]
    one = model(x)
    _close(one, jgcn.forward(jparams, j.adj, jnp.asarray(j.features)))
    both = model(torch.stack([x, 2 * x]))
    _close(both[0], one)
    _close(both[1], ex.forward(tparams, 2 * x))


def test_init_params_glorot_and_seeded():
    cfg = tgcn.GCNConfig(30, 16, 4, n_layers=3)
    p1 = tgcn.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    p2 = tgcn.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert [tuple(w.shape) for w in p1.values()] == [(30, 16), (16, 16), (16, 4)]
    for k in p1:
        assert torch.equal(p1[k], p2[k])
        din, dout = p1[k].shape
        assert float(p1[k].abs().max()) <= np.sqrt(6.0 / (din + dout))
    model = tgcn.GCN(cfg, _CpuExecutorStub(), generator=torch.Generator())
    assert model.w2.shape == (16, 4)


class _CpuExecutorStub:
    device = torch.device("cpu")

    @staticmethod
    def commit(w):
        return w
