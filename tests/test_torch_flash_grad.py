"""The flash kernel's backward (``flash_attention_cuda._FlashAttention``,
``attention_vjp``), ``launch/steps.cross_entropy``, and the meta-device
specs (``transformer.param_specs``, ``configs.input_specs``) of the port
against the JAX package on the CPU.

The attention VJP is held to ``jax.grad`` of the JAX package's
``attention_ref`` at 1e-5·max(1, |gold|max) in f32 (the reference defines
no backward for its flash kernel, so that is what its training computes);
cross-entropy at 1e-6 of its value; specs by shape and dtype, for every
arch and every shape cell the reference supports."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfgs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.kernels import flash_attention_cuda as tfa  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.training.tree import flatten_with_paths  # noqa: E402

ATTN_TOL = 1e-5


# ---------------------------------------------------------------------------
# cross-entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_jax(dtype):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = float(jsteps.cross_entropy(jnp.asarray(logits, dtype), jnp.asarray(labels)))
    got = tsteps.cross_entropy(torch.from_numpy(logits).to(getattr(torch, dtype)),
                               torch.from_numpy(labels))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * max(1.0, abs(want))


# ---------------------------------------------------------------------------
# the flash kernel's backward
# ---------------------------------------------------------------------------

# (b, sq, sk, h, hkv, d, causal, window)
VJP_CASES = [(2, 17, 17, 4, 4, 16, True, None), (1, 24, 24, 4, 2, 16, True, 5),
             (2, 13, 13, 6, 2, 8, False, None), (1, 9, 20, 4, 1, 16, True, None),
             (1, 9, 20, 4, 2, 16, True, 6), (1, 20, 9, 2, 2, 8, False, None),
             (1, 20, 9, 4, 2, 8, True, None)]


@pytest.mark.parametrize("case", VJP_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_backward_matches_jax_grad(case, monkeypatch):
    """dq, dk, dv of ``_FlashAttention`` (on the CPU its forward is the
    plain version) against ``jax.grad`` of ``attention_ref``. Causal with
    Sq > Sk: the first Sq − Sk query rows see no key and are defined by no
    version, so the output gradient is 0 there and the reference runs on
    the rows that see a key (queries aligned at Sk − Sq keep their
    positions)."""
    b, sq, sk, h, hkv, d, causal, window = case
    rng = np.random.default_rng(sum(case[:6]))
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, hkv, d)).astype(np.float32) for _ in range(2))
    dout = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    cut = max(0, sq - sk) if causal else 0
    dout[:, :cut] = 0.0

    def f(q_, k_, v_):
        out = jref.attention_ref(q_, k_, v_, causal=causal, window=window)
        return jnp.sum(out * dout[:, cut:])

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q[:, cut:]), jnp.asarray(k),
                                          jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"

    def refuse(*args, **kwargs):
        raise AssertionError("the backward must not run the plain version")

    monkeypatch.setattr(tfa, "flash_attention_plain", refuse)
    out.backward(torch.from_numpy(dout))
    for got, w in zip((tq.grad[:, cut:], tk.grad, tv.grad), want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w,
                                   atol=ATTN_TOL * max(1.0, np.abs(w).max()), rtol=0)
    assert not tq.grad[:, :cut].any()


def test_flash_without_grad_is_the_plain_launch():
    q = torch.randn(1, 5, 2, 8)
    k, v = torch.randn(1, 5, 1, 8), torch.randn(1, 5, 1, 8)
    assert tfa.flash_attention(q, k, v).grad_fn is None
    with torch.no_grad():
        assert tfa.flash_attention(q.requires_grad_(), k, v).grad_fn is None


def test_attention_vjp_in_bf16_follows_the_f32_one():
    rng = np.random.default_rng(3)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                     for s in ((1, 11, 4, 16), (1, 11, 2, 16), (1, 11, 2, 16),
                               (1, 11, 4, 16)))
    out = tfa.flash_attention_plain(q, k, v)
    f32 = tfa.attention_vjp(q, k, v, out, dout)
    b16 = tfa.attention_vjp(*(t.to(torch.bfloat16) for t in (q, k, v, out, dout)))
    for lo, hi in zip(b16, f32):
        assert lo.dtype == torch.bfloat16
        # bf16 inputs carry 2^-9 relative error each, through two products
        assert float((lo.float() - hi).abs().max()) <= 2 ** -5 * float(hi.abs().max())


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def _same_specs(got, want):
    got, want = flatten_with_paths(got), flatten_with_paths(want)
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert tuple(got[key].shape) == tuple(w.shape), key
        assert str(got[key].dtype).split(".")[-1] == str(w.dtype), key
        assert got[key].device.type == "meta"


@pytest.mark.parametrize("arch", jcfgs.list_archs())
def test_param_specs_match_the_reference(arch):
    tcfg, jcfg = tcfgs.get_config(arch), jcfgs.get_config(arch)
    _same_specs(ttr.jax_layout(tcfg, ttr.param_specs(tcfg)), jtr.param_specs(jcfg))


@pytest.mark.parametrize("arch", jcfgs.list_archs())
def test_input_specs_match_the_reference(arch):
    tcfg, jcfg = tcfgs.get_config(arch), jcfgs.get_config(arch)
    for shape in jcfgs.SHAPES:
        assert tcfgs.cell_supported(tcfg, shape) == jcfgs.cell_supported(jcfg, shape)
        if not jcfgs.cell_supported(jcfg, shape)[0]:
            continue
        got, want = tcfgs.input_specs(tcfg, shape), jcfgs.input_specs(jcfg, shape)
        if "cache" in want:  # the port keeps one dict per layer: stack by segment
            got = dict(got, cache=ttr.jax_layout(tcfg, {"layers": got["cache"]}))
        _same_specs(got, want)
