"""The port's checkpoint manager and token pipeline: the JAX package's own
tests re-run on the port's classes, checkpoints restored across the two
packages bit for bit (keys, ``meta.json`` fields, bf16 bits), token batches
equal to the JAX package's, and the port's serving CLI restoring a
checkpoint the JAX package wrote."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfgs  # noqa: E402
from repro.data.tokens import TokenPipeline as JaxPipeline  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.transformer_serve import ServeEngine as JaxEngine  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import tree as ttree  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32)),
        "b16": torch.from_numpy(rng.standard_normal(8).astype(np.float32)).to(
            torch.bfloat16),
        "nested": {"count": torch.tensor(seed, dtype=torch.int32)},
    }


def _bits(x) -> np.ndarray:
    """A leaf's bytes as numpy, bf16 and fp8 as their bits, from either
    package."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.view(torch.uint8).numpy() if x.element_size() == 1 else x.numpy()
    x = np.asarray(x)
    if "bfloat16" in str(x.dtype):
        return x.view(np.int16)
    return x.view(np.uint8) if "float8" in str(x.dtype) else x


def test_save_restore_exact(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = _tree(3)
    mgr.save(10, tree)
    got, meta = mgr.restore(tree)
    assert meta["step"] == 10
    for a, b in zip(got["w"].numpy(), tree["w"].numpy()):
        np.testing.assert_array_equal(a, b)
    assert got["b16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got["b16"]), _bits(tree["b16"]))  # bit-exact


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in [1, 2, 3, 4]:
        mgr.save(s, _tree(s))
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert len(steps) == 2
    assert mgr.latest_step() == 4


def test_preemption_ignores_partial(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(5, _tree(5))
    # simulate a crash mid-write: stray .tmp dir newer than the last good one
    bad = tmp_path / "step_000000009.tmp"
    bad.mkdir()
    (bad / "arrays.npz").write_bytes(b"garbage")
    got, meta = tckpt.simulate_preemption_restart(mgr, _tree(0))
    assert meta["step"] == 5
    assert int(got["nested"]["count"]) == 5


def test_async_writer(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_write=True)
    tree = _tree(1)
    mgr.save(1, tree, block=False)
    tree["w"].fill_(7.0)  # the snapshot was taken before the enqueue
    mgr.wait()
    assert mgr.latest_step() == 1
    got, _ = mgr.restore(tree)
    np.testing.assert_array_equal(got["w"].numpy(), _tree(1)["w"].numpy())
    mgr.close()
    assert mgr._thread is None


def test_async_writer_failure_surfaces(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", async_write=True)
    (tmp_path / "ck").rmdir()
    (tmp_path / "ck").write_text("not a directory")
    mgr.save(1, _tree(1), block=False)
    with pytest.raises(RuntimeError, match="writer failed"):
        mgr.wait()


def test_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    with pytest.raises(FileNotFoundError):
        mgr.restore(_tree(0))


def test_restore_places_leaves(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, _tree(2))
    got, _ = mgr.restore(_tree(0), device="cpu")
    assert all(t.device.type == "cpu" for t in ttree.leaves(got))
    meta_template = ttree.tree_map(lambda t: t.to("meta"), _tree(0))
    got, _ = mgr.restore(meta_template)  # each leaf to its template's device
    assert all(t.device.type == "meta" for t in ttree.leaves(got))
    with pytest.raises(KeyError):
        mgr.restore({"absent": torch.zeros(1)})


# ---- across the two packages -------------------------------------------------

def _train_state(seed):
    """``(params, adamw_init(params))`` with bf16 working weights, as numpy."""
    rng = np.random.default_rng(seed)
    params = {"w0": rng.standard_normal((5, 3)).astype(np.float32),
              "w1": rng.standard_normal((3, 2)).astype(np.float32)}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    jstate = jopt.adamw_init(jp)
    jstate["count"] = jnp.int32(seed)
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in params.items()}
    tstate = topt.adamw_init(tp)
    tstate["count"] = torch.tensor(seed, dtype=torch.int32)
    # a float8 leaf: stored as its bits too
    scale = rng.standard_normal(4).astype(np.float32)
    jstate["f8"] = jnp.asarray(scale, jnp.float8_e4m3fn)
    tstate["f8"] = torch.from_numpy(scale).to(torch.float8_e4m3fn)
    assert np.array_equal(_bits(jstate["f8"]), _bits(tstate["f8"]))
    return (jp, jstate), (tp, tstate)


def _meta(path):
    meta = json.loads(next(path.glob("step_*/meta.json")).read_text())
    return {k: v for k, v in meta.items() if k != "time"}


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jtree, ttree_ = _train_state(4)
    jckpt.CheckpointManager(tmp_path / "jax").save(7, jtree, extra={"who": "jax"})
    CheckpointManager(tmp_path / "port").save(7, ttree_, extra={"who": "jax"})
    assert _meta(tmp_path / "jax") == _meta(tmp_path / "port")
    got, meta = CheckpointManager(tmp_path / "jax").restore(_train_state(9)[1])
    assert meta["step"] == 7 and meta["extra"] == {"who": "jax"}
    want = jckpt._flatten(jtree)
    flat = ttree.flatten_with_paths(got)
    assert list(flat) == list(want)
    assert flat["0/w0"].dtype == torch.bfloat16
    assert flat["1/count"].dtype == torch.int32 and flat["1/count"].dim() == 0
    assert flat["1/f8"].dtype == torch.float8_e4m3fn
    for k in want:
        assert np.array_equal(_bits(flat[k]), _bits(want[k])), k


def test_port_checkpoint_restores_in_jax(tmp_path):
    jtree, ttree_ = _train_state(6)
    mgr = CheckpointManager(tmp_path, async_write=True)
    mgr.save(3, ttree_, block=False)
    mgr.close()
    got, meta = jckpt.CheckpointManager(tmp_path).restore(_train_state(1)[0])
    assert meta["step"] == 3
    want = ttree.flatten_with_paths(ttree_)
    flat = jckpt._flatten(got)
    assert list(flat) == list(want)
    assert str(flat["0/w1"].dtype) == "bfloat16"
    assert str(flat["1/f8"].dtype) == "float8_e4m3fn"
    for k in want:
        assert np.array_equal(_bits(flat[k]), _bits(want[k])), k


# ---- the serving CLI ---------------------------------------------------------

@pytest.mark.parametrize("with_opt_state", [True, False])
def test_serve_restores_a_jax_checkpoint(tmp_path, capsys, with_opt_state):
    cfg = jcfgs.get_reduced_config("qwen2-0.5b")
    jp = jtr.init_params(cfg, jax.random.PRNGKey(5))
    tree = (jp, jopt.adamw_init(jp)) if with_opt_state else (jp,)
    jckpt.CheckpointManager(tmp_path).save(12, tree)
    prompts = [[1, 2, 3], [7, 8]]
    outs = tserve.main(["--reduced", "--device", "cpu", "--ckpt-dir", str(tmp_path),
                        "--prompts", "1 2 3;7 8", "--max-new", "6"])
    assert "restored step 12" in capsys.readouterr().out
    assert outs == JaxEngine(cfg, jp, max_seq=64).generate(prompts, max_new_tokens=6)


# ---- data pipeline -----------------------------------------------------------

def test_pipeline_deterministic_resume():
    p1 = TokenPipeline(100, 4, 16, seed=7)
    [p1.next_batch() for _ in range(5)]
    state = p1.checkpoint_state()
    after = [p1.next_batch() for _ in range(3)]

    p2 = TokenPipeline(100, 4, 16, seed=7)
    p2.restore_state(state)
    resumed = [p2.next_batch() for _ in range(3)]
    for a, b in zip(after, resumed):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])


def test_pipeline_host_shards_differ():
    a = TokenPipeline(100, 4, 16, seed=1, host=0, num_hosts=2).next_batch()
    b = TokenPipeline(100, 4, 16, seed=1, host=1, num_hosts=2).next_batch()
    assert not np.array_equal(a["tokens"], b["tokens"])


def test_pipeline_labels_are_next_tokens():
    b = TokenPipeline(50, 2, 12, seed=3).next_batch()
    assert b["tokens"].shape == (2, 12)
    assert b["labels"].shape == (2, 12)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@pytest.mark.parametrize("seed,host,num_hosts", [(0, 0, 1), (7, 0, 2), (7, 1, 2),
                                                 (123, 3, 4)])
def test_pipeline_batches_equal_the_reference(seed, host, num_hosts):
    kw = dict(seed=seed, host=host, num_hosts=num_hosts)
    port, ref = TokenPipeline(97, 3, 20, **kw), JaxPipeline(97, 3, 20, **kw)
    for _ in range(4):
        a, b = port.next_batch(), ref.next_batch()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    assert port.checkpoint_state() == ref.checkpoint_state()
    ref2 = JaxPipeline(97, 3, 20, **kw)
    ref2.restore_state(port.checkpoint_state())
    assert np.array_equal(ref2.next_batch()["tokens"], port.next_batch()["tokens"])
