"""GCN training through the port against the JAX package's: the schedule
pair for A and Aᵀ (``registry.get_spmm_schedules``), the differentiable
kernel product (``spmm_cuda.make_spmm_fn``, whose backward runs on Aᵀ's
schedule) against the reference's ``custom_vjp`` under ``jax.grad`` and
against the dense product, ``gcn.make_schedule_spmm``, the GCN loss and its
gradients, and learning with the port's AdamW. On the CPU ``make_spmm_fn``
runs the kernels' plain versions; ``tests/test_torch_cuda.py`` holds the
kernels to them on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import csc as jfmt  # noqa: E402
from repro.core import gcn as jgcn  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.graphs import synth as jsynth  # noqa: E402
from repro.kernels import spmm_pallas  # noqa: E402
from repro.tuning import registry as jreg  # noqa: E402
from repro_torch.core import csc as tfmt  # noqa: E402
from repro_torch.core import executor as texe  # noqa: E402
from repro_torch.core import gcn as tgcn  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.graphs import synth as tsynth  # noqa: E402
from repro_torch.kernels import spmm_cuda  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.tuning import registry as treg  # noqa: E402

TOL = 1e-4
FIELDS = ("win_id", "col_block", "val", "local_row", "local_col", "row_map")
#: the JAX kernel test's geometry (``test_spmm_kernel_custom_vjp``)
SMALL = dict(nnz_per_step=16, rows_per_window=8, ktile=8)


@pytest.fixture(autouse=True)
def _fresh_caches():
    treg.clear_caches()
    jreg.clear_caches()
    yield
    treg.clear_caches()
    jreg.clear_caches()


def _close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, atol=TOL * max(1.0, np.abs(want).max()))


def _graph(n=80, density=0.06, alpha=0.9, seed=13):
    return (tsynth.power_law_adjacency(n, density, alpha, seed=seed),
            jsynth.power_law_adjacency(n, density, alpha, seed=seed))


def _operands(n, kdim, seed=13):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, kdim)).astype(np.float32),
            rng.standard_normal((kdim, kdim)).astype(np.float32))


# ---- the schedule pair -------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(nnz_per_step=16, rows_per_window=8),
                                dict(nnz_per_step=32, rows_per_window=16,
                                     cols_per_block="auto")])
def test_get_spmm_schedules_match_reference_and_cache(kw):
    ta, ja = _graph(300, 0.03, 0.9, 7)
    pair = treg.get_spmm_schedules(ta, **kw)
    want = jreg.get_spmm_schedules(ja, **kw)
    for ts, js in zip(pair, want):
        for f in FIELDS:
            assert np.array_equal(getattr(ts, f), getattr(js, f)), f
    assert pair[1].shape == (ta.shape[1], ta.shape[0])
    again = treg.get_spmm_schedules(ta, **kw)
    assert again[0] is pair[0] and again[1] is pair[1]


def test_transpose_coo_matches_reference():
    ta, ja = _graph()
    t, j = spmm_cuda.transpose_coo(ta), spmm_pallas.transpose_coo(ja)
    assert t.shape == j.shape
    for f in ("row", "col", "val"):
        assert np.array_equal(tfmt.to_numpy(getattr(t, f)), np.asarray(getattr(j, f)))


# ---- make_spmm_fn ------------------------------------------------------------

def test_spmm_kernel_custom_vjp():
    """The reference's ``test_spmm_kernel_custom_vjp`` on the port, against
    the reference's own ``custom_vjp`` and against the dense product."""
    ta, ja = _graph()
    b_np, w_np = _operands(80, 6)
    jf = spmm_pallas.make_spmm_fn(ja, interpret=True, **SMALL)
    dense = jfmt.coo_to_dense(ja)
    g_ref = jax.grad(lambda b: jnp.sum(jnp.tanh(jf(b @ w_np)) ** 2))(jnp.asarray(b_np))
    g_dense = jax.grad(lambda b: jnp.sum(jnp.tanh(dense @ (b @ w_np)) ** 2))(
        jnp.asarray(b_np))

    f = spmm_cuda.make_spmm_fn(ta, **SMALL)
    b = torch.from_numpy(b_np).requires_grad_()
    torch.sum(torch.tanh(f(b @ torch.from_numpy(w_np))) ** 2).backward()
    _close(b.grad, g_ref)
    _close(b.grad, g_dense)


@pytest.mark.parametrize("backend", [None, "torch", "cuda"])
@pytest.mark.parametrize("kind", ["default", "blocked_evil"])
def test_make_spmm_fn_vjp_matches_reference(backend, kind):
    ta, ja = _graph(96, 0.1, 1.2, 4)
    kw = dict(cols_per_block=32, evil_threshold=8) if kind == "blocked_evil" else {}
    pair_t = (tsched.build_balanced_schedule(ta, 16, 8, **kw),
              tsched.build_balanced_schedule(tfmt.transpose_coo(ta), 16, 8, **kw))
    pair_j = (jsched.build_balanced_schedule(ja, 16, 8, **kw),
              jsched.build_balanced_schedule(jfmt.transpose_coo(ja), 16, 8, **kw))
    if kind == "blocked_evil":
        assert pair_t[0].n_evil_chunks > 0 and pair_t[1].n_evil_chunks > 0
    b_np, _ = _operands(96, 9, 4)
    dc_np = np.random.default_rng(5).standard_normal((96, 9)).astype(np.float32)
    jf = spmm_pallas.make_spmm_fn(ja, ktile=8, interpret=True, schedules=pair_j)
    out_j, vjp = jax.vjp(jf, jnp.asarray(b_np))
    (db_j,) = vjp(jnp.asarray(dc_np))

    f = spmm_cuda.make_spmm_fn(ta, ktile=8, schedules=pair_t, backend=backend)
    b = torch.from_numpy(b_np).requires_grad_()
    out = f(b)
    (db,) = torch.autograd.grad(out, b, torch.from_numpy(dc_np))
    _close(out, out_j)
    _close(db, db_j)
    _close(db, np.asarray(jfmt.coo_to_dense(ja)).T @ dc_np)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_make_spmm_fn_bf16_operand(dtype):
    ta, ja = _graph()
    b_np, _ = _operands(80, 5)
    f = spmm_cuda.make_spmm_fn(ta, **SMALL)
    b = torch.from_numpy(b_np).to(dtype).requires_grad_()
    out = f(b)
    assert out.dtype == dtype
    out.float().sum().backward()
    assert b.grad.dtype == dtype
    dense = np.asarray(jfmt.coo_to_dense(ja))
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    gold = dense.T @ np.ones((80, 5), np.float32)
    np.testing.assert_allclose(b.grad.float().numpy(), gold,
                               atol=tol * max(1.0, np.abs(gold).max()))


def test_backward_takes_expanded_and_strided_grads():
    ta, ja = _graph()
    dense_t = np.asarray(jfmt.coo_to_dense(ja)).T
    b_np, _ = _operands(80, 6)
    f = spmm_cuda.make_spmm_fn(ta, **SMALL)
    # out.sum(): autograd hands over a stride-0 expansion of one scalar
    b = torch.from_numpy(b_np).requires_grad_()
    f(b).sum().backward()
    _close(b.grad, dense_t @ np.ones((80, 6), np.float32))
    # a gradient that is a transposed (non-contiguous) view
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((6, 80)).astype(
        np.float32)).t()
    assert not g.is_contiguous()
    b = torch.from_numpy(b_np).requires_grad_()
    f(b).backward(g)
    _close(b.grad, dense_t @ g.numpy())


def test_adjacency_values_get_no_gradient_and_double_backward_raises():
    ta, _ = _graph()
    val = ta.val.clone().requires_grad_()
    f = spmm_cuda.make_spmm_fn(ta._replace(val=val), **SMALL)
    b = torch.from_numpy(_operands(80, 4)[0]).requires_grad_()
    out = f(b)
    (db,) = torch.autograd.grad(out.square().sum(), b, create_graph=True)
    assert val.grad is None
    with pytest.raises(RuntimeError, match="once_differentiable|twice"):
        db.sum().backward()
    assert val.grad is None


def test_make_spmm_fn_validates_and_uploads_once(monkeypatch):
    ta, _ = _graph()
    with pytest.raises(ValueError, match="unknown routing"):
        spmm_cuda.make_spmm_fn(ta, routing="mxu", **SMALL)
    with pytest.raises(ValueError, match="unknown backend"):
        spmm_cuda.make_spmm_fn(ta, backend="pallas", **SMALL)
    for routing in ("auto", "gather", "onehot"):
        spmm_cuda.make_spmm_fn(ta, routing=routing, **SMALL)
    uploads = []
    real = texe._upload_plan
    monkeypatch.setattr(texe, "_upload_plan",
                        lambda *a, **k: uploads.append(1) or real(*a, **k))
    f = spmm_cuda.make_spmm_fn(ta, **SMALL)
    b = torch.from_numpy(_operands(80, 4)[0])
    for step in range(3):
        bb = b.clone().requires_grad_()
        f(bb).sum().backward()
        assert len(uploads) == 2  # A's at the first forward, Aᵀ's at its backward
        texe._DEVICE_STEPS.clear()  # an evicted upload is still held by f
    assert f.sched is treg.get_spmm_schedules(ta, nnz_per_step=16,
                                              rows_per_window=8)[0]


# ---- GCN ---------------------------------------------------------------------

def test_make_schedule_spmm():
    """``test_schedule_reuse_across_layers`` on the port, with values."""
    t = tsynth.make_dataset("pubmed", scale=16, device="cpu")
    j = jsynth.make_dataset("pubmed", scale=16)
    cfg = jgcn.GCNConfig(j.num_features, 16, j.num_classes)
    jp = jgcn.init_params(cfg, jax.random.PRNGKey(0))
    tp = tgcn.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    js = jsched.build_balanced_schedule(j.adj, 64, 32)
    ts = tsched.build_balanced_schedule(t.adj, 64, 32)
    jf, tf = jgcn.make_schedule_spmm(js), tgcn.make_schedule_spmm(ts)
    x = torch.from_numpy(t.features)
    w0 = tp["w0"].clone().requires_grad_()
    h1 = tf(x @ w0)
    h2 = tf(torch.relu(h1) @ tp["w1"])
    assert h1.shape == (t.num_nodes, 16)
    assert h2.shape == (t.num_nodes, t.num_classes)
    jh1 = jf(jnp.asarray(j.features) @ jp["w0"])
    _close(h1, jh1)
    _close(h2, jf(jax.nn.relu(jh1) @ jp["w1"]))
    h2.square().sum().backward()  # autograd goes through the plain executor
    g = jax.grad(lambda w: jnp.sum(jf(jax.nn.relu(jf(jnp.asarray(j.features) @ w))
                                      @ jp["w1"]) ** 2))(jp["w0"])
    _close(w0.grad, g)


@pytest.fixture(scope="module")
def cora():
    t = tsynth.make_dataset("cora", seed=0, scale=4, device="cpu")
    j = jsynth.make_dataset("cora", seed=0, scale=4)
    cfg = jgcn.GCNConfig(j.num_features, j.hidden, j.num_classes)
    jp = jgcn.init_params(cfg, jax.random.PRNGKey(0))
    return t, j, jp, tgcn.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def test_gcn_loss_and_grads_through_make_spmm_fn(cora):
    t, j, jp, tp = cora
    kw = dict(nnz_per_step=64, rows_per_window=16, ktile=8)
    jf = spmm_pallas.make_spmm_fn(j.adj, interpret=True, **kw)
    mask = (np.arange(j.num_nodes) % 3 == 0).astype(np.float32)
    jloss, jg = jax.value_and_grad(lambda p: jgcn.loss_fn(
        p, j.adj, jnp.asarray(j.features), jnp.asarray(j.labels), jnp.asarray(mask),
        spmm_fn=jf))(jp)

    f = spmm_cuda.make_spmm_fn(t.adj, **kw)
    params = {k: v.clone().requires_grad_() for k, v in tp.items()}
    loss = tgcn.loss_fn(params, t.adj, torch.from_numpy(t.features),
                        torch.from_numpy(j.labels), torch.from_numpy(mask), spmm_fn=f)
    grads = torch.autograd.grad(loss, list(params.values()))
    _close(loss, jloss)
    for k, g in zip(params, grads):
        _close(g, jg[k])
    # and the same through the plain COO product, which autograd differentiates
    coo_grads = torch.autograd.grad(
        tgcn.loss_fn(params, t.adj, torch.from_numpy(t.features),
                     torch.from_numpy(j.labels), torch.from_numpy(mask)),
        list(params.values()))
    for g, c in zip(grads, coo_grads):
        _close(g, c.numpy())


@pytest.mark.parametrize("route", ["coo", "make_spmm_fn"])
def test_gcn_learns_teacher_labels(route):
    """The reference's ``test_gcn_learns_teacher_labels`` with the port's
    AdamW, through the plain COO product or the kernels' differentiable
    product (their plain versions on the CPU)."""
    t = tsynth.make_dataset("citeseer", seed=1, scale=4, device="cpu")
    cfg = jgcn.GCNConfig(t.num_features, 16, t.num_classes)
    params = tgcn.params_from_jax(
        jax.tree.map(np.asarray, jgcn.init_params(cfg, jax.random.PRNGKey(1))), "cpu")
    x = torch.from_numpy(t.features)
    labels = torch.from_numpy(np.asarray(t.labels))
    spmm_fn = spmm_cuda.make_spmm_fn(t.adj) if route == "make_spmm_fn" else None
    ocfg = topt.AdamWConfig(lr=0.05, warmup_steps=5, total_steps=60, weight_decay=0.0)
    state = topt.adamw_init(params)
    losses = []
    for _ in range(60):
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = tgcn.loss_fn(p, t.adj, x, labels, spmm_fn=spmm_fn)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        params, state, _ = topt.adamw_update(ocfg, grads, state,
                                             param_dtype=torch.float32)
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] - 0.3
    acc = float(tgcn.accuracy(params, t.adj, x, labels))
    assert acc > 1.0 / t.num_classes + 0.15  # well above chance
