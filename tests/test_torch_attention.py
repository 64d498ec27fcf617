"""Parity of the port's attention (the flash kernel's plain version, the
attention oracles and ``ops.attention``) with the JAX package's Pallas flash
kernel in interpret mode and its oracles, on the same numpy inputs made
from a seed. Tolerances are the JAX kernel tests': 2e-5 in f32, 5e-2 in
bf16 against the f32 oracle."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as fa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention_cuda as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

SWEEP = [
    (2, 32, 32, 4, 4, 16),
    (1, 48, 48, 8, 2, 32),   # GQA
    (2, 16, 64, 4, 1, 16),   # decode-style continuation (Sq < Sk)
    (1, 40, 40, 2, 2, 16),   # non-multiple of block
]


def _qkv(seed, b, sq, sk, h, hkv, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))


def _jax(arrs):
    return tuple(jnp.asarray(a) for a in arrs)


def _torch(arrs):
    return tuple(torch.from_numpy(a) for a in arrs)


@pytest.mark.parametrize("b,sq,sk,h,hkv,d", SWEEP)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_and_oracles(b, sq, sk, h, hkv, d, causal):
    arrs = _qkv(b * sq + h, b, sq, sk, h, hkv, d)
    pallas = np.asarray(fa.flash_attention(*_jax(arrs), causal=causal, block_q=16,
                                           block_k=16, interpret=True))
    gold = np.asarray(jref.attention_ref(*_jax(arrs), causal=causal))
    chunked = np.asarray(jref.attention_chunked(*_jax(arrs), causal=causal,
                                                block_k=16))
    plain = tfa.flash_attention(*_torch(arrs), causal=causal)  # CPU: plain version
    np.testing.assert_allclose(plain.numpy(), pallas, atol=2e-5)
    np.testing.assert_allclose(tfa.flash_attention_plain(*_torch(arrs), causal=causal)
                               .numpy(), gold, atol=2e-5)
    np.testing.assert_allclose(tref.attention_ref(*_torch(arrs), causal=causal)
                               .numpy(), gold, atol=2e-5)
    np.testing.assert_allclose(tref.attention_chunked(*_torch(arrs), causal=causal,
                                                      block_k=16).numpy(),
                               chunked, atol=2e-5)


@pytest.mark.parametrize("window", [8, 24])
def test_flash_plain_window(window):
    arrs = _qkv(window, 1, 64, 64, 4, 2, 16)
    pallas = np.asarray(fa.flash_attention(*_jax(arrs), causal=True, window=window,
                                           block_q=16, block_k=16, interpret=True))
    gold = np.asarray(jref.attention_ref(*_jax(arrs), causal=True, window=window))
    plain = tfa.flash_attention_plain(*_torch(arrs), causal=True, window=window)
    np.testing.assert_allclose(plain.numpy(), pallas, atol=2e-5)
    for fn in (tref.attention_ref, tfa.flash_attention_plain):
        np.testing.assert_allclose(fn(*_torch(arrs), causal=True, window=window)
                                   .numpy(), gold, atol=2e-5)
    np.testing.assert_allclose(
        tref.attention_chunked(*_torch(arrs), window=window, block_k=16).numpy(),
        np.asarray(jref.attention_chunked(*_jax(arrs), window=window, block_k=16)),
        atol=2e-5)


def test_flash_plain_window_without_causal():
    arrs = _qkv(3, 1, 40, 40, 4, 2, 16)
    gold = np.asarray(jref.attention_ref(*_jax(arrs), causal=False, window=8))
    pallas = np.asarray(fa.flash_attention(*_jax(arrs), causal=False, window=8,
                                           block_q=16, block_k=16, interpret=True))
    np.testing.assert_allclose(pallas, gold, atol=2e-5)
    plain = tfa.flash_attention_plain(*_torch(arrs), causal=False, window=8)
    np.testing.assert_allclose(plain.numpy(), gold, atol=2e-5)


def test_flash_plain_bf16():
    arrs = _qkv(7, 2, 32, 32, 4, 2, 16)
    gold = np.asarray(jref.attention_ref(*_jax(arrs)))
    bf = tuple(t.to(torch.bfloat16) for t in _torch(arrs))
    out = tfa.flash_attention_plain(*bf)
    assert out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - gold).max() < 5e-2
    pallas = fa.flash_attention(*(a.astype(jnp.bfloat16) for a in _jax(arrs)),
                                block_q=16, block_k=16, interpret=True)
    assert np.abs(out.float().numpy() - np.asarray(pallas, np.float32)).max() < 5e-2
    # the oracle casts p to v's dtype before the PV product, as the JAX one
    ref_bf = tref.attention_ref(*bf)
    jref_bf = jref.attention_ref(*(a.astype(jnp.bfloat16) for a in _jax(arrs)))
    assert ref_bf.dtype == torch.bfloat16
    assert np.abs(ref_bf.float().numpy() - np.asarray(jref_bf, np.float32)).max() < 5e-2


# head width 256 (recurrentgemma-2b's local layers: MQA, group 10) and
# Sq > Sk (whisper's cross-attention over the encoder's frames):
# (b, sq, sk, h, hkv, d, causal, window)
WIDE = [
    (1, 40, 40, 10, 1, 256, True, None),
    (1, 40, 40, 10, 1, 256, True, 8),
    (1, 24, 72, 4, 1, 256, True, 24),     # Sq < Sk
    (2, 33, 33, 2, 2, 256, False, None),
    (1, 50, 20, 2, 2, 256, False, None),  # Sq > Sk, non-causal
    (1, 50, 20, 6, 6, 64, False, None),   # whisper's width
    (1, 1, 30, 6, 6, 64, False, None),    # decode's cross-attention, Sq 1
]


@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal,window", WIDE)
def test_flash_plain_matches_pallas_wide_and_cross(b, sq, sk, h, hkv, d, causal, window):
    arrs = _qkv(sq + sk + d, b, sq, sk, h, hkv, d)
    pallas = np.asarray(fa.flash_attention(*_jax(arrs), causal=causal, window=window,
                                           block_q=16, block_k=16, interpret=True))
    plain = tfa.flash_attention(*_torch(arrs), causal=causal, window=window)
    tol = 2e-5 * max(1.0, float(np.abs(pallas).max()))
    np.testing.assert_allclose(plain.numpy(), pallas, atol=tol, rtol=0)
    gold = np.asarray(jref.attention_ref(*_jax(arrs), causal=causal, window=window))
    np.testing.assert_allclose(tops.attention(*_torch(arrs), causal=causal,
                                              window=window).numpy(), gold, atol=tol)


def test_causal_sq_over_sk_agrees_where_a_row_sees_a_key():
    """Causal with Sq > Sk leaves the first Sq − Sk query rows no key: the
    reference's oracle gives NaN there and its Pallas kernel gives mean(V)
    or 0 by block, so no version is right; the rows that see a key agree."""
    arrs = _qkv(11, 1, 50, 20, 4, 2, 256)
    pallas = np.asarray(fa.flash_attention(*_jax(arrs), causal=True, block_q=16,
                                           block_k=16, interpret=True))
    gold = np.asarray(jref.attention_ref(*_jax(arrs), causal=True))
    plain = tfa.flash_attention(*_torch(arrs), causal=True).numpy()
    assert np.isnan(gold[:, :30]).all() and not np.isnan(gold[:, 30:]).any()
    tol = 2e-5 * max(1.0, float(np.abs(gold[:, 30:]).max()))
    np.testing.assert_allclose(plain[:, 30:], pallas[:, 30:], atol=tol, rtol=0)
    np.testing.assert_allclose(plain[:, 30:], gold[:, 30:], atol=tol, rtol=0)


def test_ops_attention_dispatch(monkeypatch):
    arrs = _torch(_qkv(11, 1, 32, 32, 4, 2, 16))
    calls = []
    for mod, name in ((tref, "attention_ref"), (tref, "attention_chunked"),
                      (tfa, "flash_attention"), (tfa, "flash_attention_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    a_ref = tops.attention(*arrs)
    a_chunk = tops.attention(*arrs, chunk=8)
    a_torch = tops.attention(*arrs, backend="torch", window=8)
    assert calls == ["attention_ref", "attention_chunked", "attention_ref"]
    np.testing.assert_allclose(a_ref.numpy(), a_chunk.numpy(), atol=2e-5)
    np.testing.assert_allclose(
        a_torch.numpy(), tfa.flash_attention_plain(*arrs, window=8).numpy(), atol=2e-5)
    with pytest.raises(ValueError, match="cuda"):
        tops.attention(*arrs, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        tops.attention(*arrs, backend="pallas")


def test_wrapper_checks_operands_on_the_cpu():
    q, k, v = _torch(_qkv(1, 1, 16, 16, 4, 2, 16))
    with pytest.raises(ValueError, match="kv heads"):
        tfa.flash_attention(q, k[:, :, :1].expand(1, 16, 3, 16).contiguous(),
                            v[:, :, :1].expand(1, 16, 3, 16).contiguous())
    with pytest.raises(ValueError, match="do not match"):
        tfa.flash_attention(q, k[..., :8], v[..., :8])
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention(q, k, v, window=0)
    assert tfa.LAUNCHES["flash_attention"] == 0  # the CPU never launches


@pytest.mark.parametrize("d", tfa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_the_kernel_entry_is_chosen_by_head_width_and_dtype(d, dtype, monkeypatch):
    """bf16 at head width 256 launches the wgmma library's entry
    (``flash_attention_wgmma.cu``), every other (D, dtype) the mma.sync
    library's, as before. ``kernel_library`` makes the choice and the
    operator follows it; here its libraries, the device guard and the
    stream are stand-ins (no nvcc, no card), so only the choice, the
    arguments and the launch counts are checked."""
    import contextlib
    import types

    want = ("flash_attention_wgmma" if (d, dtype) == (256, torch.bfloat16)
            else "flash_attention")
    assert tfa.kernel_library(d, dtype) == want
    calls = []

    class Lib:
        def awb_flash_attention(self, *args):
            calls.append(("flash_attention", args))
            return 0

        def awb_flash_attention_wgmma(self, *args):
            calls.append(("flash_attention_wgmma", args))
            return 0

    monkeypatch.setattr(tfa, "_lib", lambda name="flash_attention": Lib())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=7))
    q = torch.zeros((2, 5, 4, d), dtype=dtype)
    k = torch.zeros((2, 9, 2, d), dtype=dtype)
    tfa.reset_launches()
    tfa.flash_attention_op(q, k, k, True, 3, 0.5)
    assert [name for name, _ in calls] == [want]
    args = calls[0][1]
    assert args[4:13] == (2, 5, 9, 4, 2, d, 1, 3, 0.5) and args[-1] == 7
    if want == "flash_attention":
        assert args[13] == int(dtype == torch.bfloat16)
    assert tfa.LAUNCHES == {name: int(name == want) for name in tfa.LAUNCHES}
    tfa.reset_launches()


def _tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: the f32 bit pattern rounded to 10 mantissa bits,
    ties away from zero (adding half of the dropped range to the magnitude)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_product(eq: str, a: np.ndarray, b: np.ndarray, passes: int) -> np.ndarray:
    """The flash kernel's f32 products on tensor cores: one pass rounds both
    operands to tf32; three passes add hi·lo and lo·hi to hi·hi, with
    hi = tf32(x) and lo = tf32(x - hi). Summed exactly, rounded to f32: the
    tensor core's accumulation, which is not round-to-nearest, is left out."""
    ah, bh = _tf32(a), _tf32(b)
    terms = [(ah, bh)]
    if passes == 3:
        al, bl = _tf32(a - ah), _tf32(b - bh)
        terms += [(ah, bl), (al, bh)]
    return sum(np.einsum(eq, x.astype(np.float64), y.astype(np.float64))
               for x, y in terms).astype(np.float32)


def _attention_tf32(q, k, v, causal, passes):
    """Attention as the kernel computes it in f32 (softmax in f32), with
    ``passes`` tf32 passes for Q·Kᵀ and P·V; ``passes`` 0 is the f64 gold."""
    b, sq, h, d = q.shape
    sk, groups = k.shape[1], h // k.shape[2]
    kk, vv = (np.repeat(x, groups, axis=2) for x in (k, v))
    if passes:
        s = _tf32_product("bqhd,bkhd->bhqk", q, kk, passes) * np.float32(d ** -0.5)
    else:
        s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) * d ** -0.5
    if causal:
        mask = np.arange(sk)[None, :] <= np.arange(sq)[:, None] + (sk - sq)
        s = np.where(mask, s, tfa.NEG_INF)
    p = np.exp(s - s.max(-1, keepdims=True))
    denom = np.maximum(p.sum(-1, keepdims=True), tfa.L_FLOOR)
    if passes:
        o = _tf32_product("bhqk,bkhd->bhqd", p.astype(np.float32), vv, passes)
    else:
        o = np.einsum("bhqk,bkhd->bhqd", p, vv.astype(np.float64))
    return (o / denom).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("b,sq,sk,h,hkv,d", SWEEP + [(1, 1000, 1000, 4, 2, 64),
                                                     (1, 1000, 1000, 4, 1, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_split_meets_the_f32_tolerance(b, sq, sk, h, hkv, d, causal):
    """The record of why the f32 kernel runs three tf32 passes and not one:
    with tf32 rounding emulated, one pass misses the f32 attention tolerance
    2e-5·max(1, |gold|max) and the hi/lo split meets it. The emulation sums
    the products exactly, so its margin is not the kernel's: the card's
    truncating accumulation adds error, and PERF.md gives the kernel's
    measured error against the same tolerance."""
    q, k, v = _qkv(b * sq + h + d, b, sq, sk, h, hkv, d)
    gold = _attention_tf32(q, k, v, causal, passes=0)
    tol = 2e-5 * max(1.0, float(np.abs(gold).max()))
    plain = tfa.flash_attention_plain(*_torch((q, k, v)), causal=causal).numpy()
    assert np.abs(plain - gold).max() <= tol
    assert np.abs(_attention_tf32(q, k, v, causal, passes=3) - gold).max() <= tol
    assert np.abs(_attention_tf32(q, k, v, causal, passes=1) - gold).max() > tol
