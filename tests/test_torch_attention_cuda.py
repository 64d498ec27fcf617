"""The hand-written flash-attention kernel against its plain PyTorch version,
on the card. Every test here needs a CUDA device and skips without one; run
them on the card with
``python -m pytest -m cuda tests/test_torch_attention_cuda.py``. This file
imports no JAX, so it runs where only PyTorch is installed. Tolerances are
the JAX kernel tests': 2e-5·max(1, |gold|max) in f32, 5e-2 in bf16. bf16 at
head width 256 runs the wgmma kernel (``flash_attention_wgmma.cu``), every
other case the mma.sync kernel; each test that counts launches counts the
kernel ``flash_attention_cuda.kernel_library`` names for its case."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.kernels import flash_attention_cuda as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.transformer_serve import ServeEngine  # noqa: E402

pytestmark = pytest.mark.cuda

# (b, sq, sk, h, hkv, d): the JAX kernel tests' shapes, then the widths of
# the configs (64, 128, 256) at a length that is no multiple of any tile
SHAPES = [
    (2, 32, 32, 4, 4, 16),
    (1, 48, 48, 8, 2, 32),
    (2, 16, 64, 4, 1, 16),
    (1, 40, 40, 2, 2, 16),
    (1, 1000, 1000, 4, 2, 64),
    (1, 1000, 1000, 4, 1, 128),
    # lengths that cut the 64-query tiles and the 32/64-key cp.async ring at
    # every edge, every head width, GQA groups of 1, 2 and 7 (qwen2-0.5b's)
    (1, 1, 1, 2, 2, 64),
    (2, 15, 15, 7, 1, 32),
    (1, 17, 17, 14, 2, 64),
    (1, 63, 63, 4, 2, 128),
    (1, 65, 65, 2, 1, 16),
    (2, 129, 129, 2, 2, 32),
    (1, 129, 129, 14, 2, 64),
    (1, 15, 63, 2, 2, 16),
    (1, 1, 129, 4, 2, 64),
    (1, 65, 1000, 4, 2, 32),
    (1, 17, 1000, 7, 1, 128),
    (1, 129, 1000, 14, 2, 16),
    # head width 256 (recurrentgemma-2b's local layers): MQA with group 10,
    # ragged tiles of the 16-key f32 ring and the 64-query tiles, Sq < Sk
    (1, 130, 130, 10, 1, 256),
    (2, 65, 65, 4, 2, 256),
    (1, 1, 1, 2, 1, 256),
    (1, 17, 300, 10, 1, 256),
    (1, 1, 129, 10, 1, 256),
    (1, 1000, 1000, 10, 1, 256),
]
# Sq > Sk (cross-attention over fewer keys than queries): causal rows before
# the first key see nothing, and no version defines them (the reference's
# oracle gives NaN there), so those rows are left out of the comparison
SQ_OVER_SK = [
    (1, 200, 70, 6, 6, 64),
    (2, 100, 33, 4, 2, 16),
    (1, 300, 70, 4, 2, 256),
    (1, 130, 17, 10, 1, 256),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _qkv(dev, seed, b, sq, sk, h, hkv, d, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(dev, dtype)
                 for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))


def _tol(gold, dtype):
    return (2e-5 * max(1.0, float(gold.abs().max())) if dtype == torch.float32
            else 5e-2)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 8),
                                           (True, 24), (False, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(dev, shape, causal, window, dtype):
    q, k, v = _qkv(dev, sum(shape), *shape, dtype=dtype)
    name = tfa.kernel_library(shape[-1], dtype)
    assert (name == "flash_attention_wgmma") == (shape[-1] == 256 and dtype == torch.bfloat16)
    before = dict(tfa.LAUNCHES)
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == dict(before, **{name: before[name] + 1})
    assert got.dtype == dtype and got.shape == q.shape and got.is_cuda
    gold = tfa.flash_attention_plain(q.float(), k.float(), v.float(), causal=causal,
                                     window=window)
    assert float((got.float() - gold).abs().max()) <= _tol(gold, dtype)


def _seen_rows(sq, sk, causal, window):
    """The query rows that see at least one key."""
    qpos = np.arange(sq) + sk - sq
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, np.int64)
    return torch.from_numpy(hi > lo)


@pytest.mark.parametrize("shape", SQ_OVER_SK, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("causal,window", [(False, None), (False, 24), (True, None),
                                           (True, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version_with_more_queries_than_keys(dev, shape, causal,
                                                                  window, dtype):
    b, sq, sk = shape[:3]
    q, k, v = _qkv(dev, sum(shape) + 1, *shape, dtype=dtype)
    got = tfa.flash_attention(q, k, v, causal=causal, window=window).float()
    gold = tfa.flash_attention_plain(q.float(), k.float(), v.float(), causal=causal,
                                     window=window)
    rows = _seen_rows(sq, sk, causal, window).to(dev)
    assert bool(rows.all()) == (not causal)
    got, gold = got[:, rows], gold[:, rows]
    assert float((got - gold).abs().max()) <= _tol(gold, dtype)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_is_deterministic(dev, d, dtype):
    q, k, v = _qkv(dev, 1, 2, 300, 300, 8, 2, d, dtype=dtype)
    first = tfa.flash_attention(q, k, v)
    for _ in range(3):
        assert torch.equal(tfa.flash_attention(q, k, v), first)


@pytest.mark.parametrize("operand", ["q", "k"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nan_reaches_the_rows_that_see_it(dev, operand, d, dtype):
    """The card's canonical NaN (0x7fffffff), which a carry in the tf32
    rounding would turn into -0, comes out as NaN in exactly the rows where
    the plain version gives NaN; the other rows keep their tolerance."""
    qkv = dict(zip("qkv", _qkv(dev, 4, 2, 130, 130, 4, 2, d)))
    bits = qkv[operand].view(torch.int32)
    bits[0, 70, 1, 5] = 0x7FFFFFFF
    bits[1, 3, 0, d - 1] = 0x7FFFFFFF
    q, k, v = (qkv[n].to(dtype) for n in "qkv")
    got = tfa.flash_attention(q, k, v).float()
    gold = tfa.flash_attention_plain(q.float(), k.float(), v.float())
    assert gold.isnan().any() and not gold.isnan().all()
    assert torch.equal(got.isnan(), gold.isnan())
    keep = ~gold.isnan()
    assert float((got[keep] - gold[keep]).abs().max()) <= _tol(gold[keep], dtype)


def test_ops_dispatch_on_the_card(dev):
    q, k, v = _qkv(dev, 2, 1, 64, 64, 4, 2, 32)
    tfa.reset_launches()
    plain = tops.attention(q, k, v, backend="torch")
    assert tfa.LAUNCHES["flash_attention"] == 0
    got = tops.attention(q, k, v, chunk=16)  # chunk is ignored on the card
    assert tfa.LAUNCHES["flash_attention"] == 1
    assert float((got - plain).abs().max()) <= _tol(plain, torch.float32)


def test_prefill_launches_once_per_layer(dev):
    cfg = tcfgs.get_reduced_config("qwen2-0.5b")
    params = ttr.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 40), device=dev)
    tfa.reset_launches()
    logits, _ = ttr.prefill(cfg, params, {"tokens": toks}, max_seq=48,
                            compute_dtype=torch.float32)
    assert tfa.LAUNCHES["flash_attention"] == cfg.n_layers
    gold, _ = ttr.prefill(cfg, params, {"tokens": toks}, max_seq=48, backend="torch",
                          compute_dtype=torch.float32)
    assert tfa.LAUNCHES["flash_attention"] == cfg.n_layers
    assert float((logits - gold).abs().max()) <= 2e-3 * max(1.0, float(gold.abs().max()))


def test_serve_engine_on_the_card_matches_the_cpu(dev):
    cfg = tcfgs.get_reduced_config("qwen2-0.5b")
    params = ttr.init_params(cfg, torch.Generator().manual_seed(1))
    prompts = [[3, 4, 5, 6], [7, 8]]
    want = ServeEngine(cfg, params, max_seq=16, device="cpu").generate(prompts, 6)
    tfa.reset_launches()
    got = ServeEngine(cfg, params, max_seq=16, device=dev).generate(prompts, 6)
    assert got == want
    assert tfa.LAUNCHES["flash_attention"] == cfg.n_layers


@pytest.mark.parametrize("arch", ["whisper-tiny", "recurrentgemma-2b"])
def test_encoder_and_hybrid_models_serve_on_the_card_as_on_the_cpu(dev, arch):
    """Reduced whisper-tiny (encoder, self- and cross-attention through the
    kernel, cross-attention in every decode step) and recurrentgemma-2b
    (local layers through the kernel in the prefill): the card's tokens and
    logits against the CPU's, teacher-forced, and the launch counts."""
    cfg = tcfgs.get_reduced_config(arch)
    params = ttr.init_params(cfg, torch.Generator().manual_seed(2))
    prompts, new = [[3, 4, 5, 6], [7, 8]], 6
    src = None
    if cfg.encoder is not None:
        src = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (2, 10, cfg.d_model)).astype(np.float32))
    tfa.reset_launches()
    toks, logits = ServeEngine(cfg, params, max_seq=16, device=dev).run(
        prompts, new, source_embed=src)
    kinds = ttr.layer_kinds(cfg)
    if cfg.encoder is not None:  # encoder + self + cross in the prefill, cross a step
        want = cfg.encoder.n_layers + 2 * len(kinds) + len(kinds) * (new - 1)
    else:
        want = sum(k == "local" for k in kinds)
    assert tfa.LAUNCHES["flash_attention"] == want
    _, gold = ServeEngine(cfg, params, max_seq=16, device="cpu").run(
        prompts, new, forced=torch.tensor([t[-new:] for t in toks]), source_embed=src)
    np.testing.assert_allclose(logits.cpu().numpy(), gold.numpy(),
                               atol=2e-3 * max(1.0, float(gold.abs().max())), rtol=0)


def test_wrapper_rejects_bad_operands(dev):
    q, k, v = _qkv(dev, 3, 1, 16, 16, 4, 2, 16)
    with pytest.raises(ValueError, match="head width"):
        tfa.flash_attention(*_qkv(dev, 3, 1, 16, 16, 4, 2, 24))
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="kv heads"):
        q3 = torch.zeros((1, 16, 3, 16), device=dev)
        tfa.flash_attention(q3, k, v)
    with pytest.raises(ValueError, match="do not match"):
        tfa.flash_attention(q, k, v[:, :8])
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        tfa.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        tfa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="16-byte"):
        shifted = torch.zeros(q.numel() + 1, device=dev)[1:].view(q.shape)
        tfa.flash_attention(shifted, k, v)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="cuda"):
        tops.attention(q.cpu(), k.cpu(), v.cpu(), backend="cuda")


@pytest.mark.parametrize("shape", [(2, 100, 100, 4, 2, 64), (1, 65, 130, 14, 2, 64),
                                   (1, 130, 130, 10, 1, 256), (1, 70, 33, 4, 2, 16)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grads_through_the_kernel_match_the_plain_version(dev, shape, causal, window,
                                                          dtype):
    """``_FlashAttention`` (the kernel's forward, the VJP in torch ops)
    against autograd through the plain version on the same inputs: in f32
    the forward at the kernel tolerance and the grads at 1e-4·max (the VJP
    reads the kernel's output); in bf16 (D 256: the wgmma kernel) the
    forward at bf16's 5e-2 and the grads at 5e-2·max(1, |grad|max), the
    output's bf16 rounding reaching them through rowsum(dO∘O). Causal rows
    that see no key (Sq > Sk) carry no output gradient."""
    q, k, v = _qkv(dev, sum(shape), *shape, dtype=dtype)
    dout = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(1),
                       device=dev).to(dtype)
    b, sq, sk = shape[:3]
    if causal:
        dout[:, :max(0, sq - sk)] = 0.0
    grads = []
    name = tfa.kernel_library(shape[-1], dtype)
    for fn in (tfa.flash_attention, tfa.flash_attention_plain):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = tfa.LAUNCHES[name]
        out = fn(*leaves, causal=causal, window=window)
        launched = tfa.LAUNCHES[name] - before
        out.backward(dout)
        grads.append((out.detach(), *(t.grad for t in leaves)))
        assert launched == (1 if fn is tfa.flash_attention else 0)
    keep = _seen_rows(sq, sk, causal, window)
    (out, *got), (gold_out, *want) = grads
    out, gold_out = out.float(), gold_out.float()
    assert float((out[:, keep] - gold_out[:, keep]).abs().max()) <= _tol(gold_out, dtype)
    rel = 1e-4 if dtype == torch.float32 else 5e-2
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        assert float((g - w).abs().max()) <= rel * max(1.0, float(w.abs().max()))


def test_a_remat_train_step_launches_twice_a_layer(dev):
    """Reduced qwen2-0.5b with ``remat``: the flash forward runs once in the
    forward and once in the backward's recompute of each layer; the loss
    and grads equal the plain attention's under autograd within bf16's
    reach."""
    import dataclasses

    from repro_torch.launch import steps

    cfg = dataclasses.replace(tcfgs.get_reduced_config("qwen2-0.5b"), remat=True)
    params = ttr.init_params(cfg, torch.Generator(device=dev).manual_seed(3))
    toks = torch.randint(0, cfg.vocab, (2, 33), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(4))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tfa.reset_launches()
    loss, grads = steps.value_and_grad(cfg, params, batch, compute_dtype=torch.float32)
    assert tfa.LAUNCHES["flash_attention"] == 2 * cfg.n_layers
    gold, gold_grads = steps.value_and_grad(cfg, params, batch, backend="torch",
                                            compute_dtype=torch.float32)
    assert tfa.LAUNCHES["flash_attention"] == 2 * cfg.n_layers
    assert abs(float(loss) - float(gold)) <= 1e-5 * abs(float(gold))
    from repro_torch.training.tree import flatten_with_paths

    for key, w in flatten_with_paths(gold_grads).items():
        g = flatten_with_paths(grads)[key]
        assert float((g - w).abs().max()) <= 1e-3 * max(1e-6, float(w.abs().max())), key
