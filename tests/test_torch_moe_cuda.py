"""The MoE layer and a reduced MoE model on the card against the same code
on the CPU: routing decisions equal (ranks, slots and capacity drops are
exact integers on both devices), outputs within 1e-5 (``tests/test_moe.py``'s
tolerance), and a served run's logits within 2e-3 of the CPU's,
teacher-forced. Every test here needs a CUDA device and skips without one;
run them on the card with
``python -m pytest -m cuda tests/test_torch_moe_cuda.py``. This file imports
no JAX."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.core import moe_balance  # noqa: E402
from repro_torch.kernels import flash_attention_cuda as tfa  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.transformer_serve import ServeEngine  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _to(tree, dev):
    return {k: v.to(dev) for k, v in tree.items()}


@pytest.mark.parametrize("case", [
    dict(capacity_factor=64.0), dict(capacity_factor=1.0), dict(capacity_factor=0.05),
    dict(n_groups=4, capacity_factor=1.0), dict(n_slots=12, capacity_factor=1.0),
    dict(n_slots=12, capacity_factor=64.0, placement=True),
    dict(n_slots=12, capacity_factor=0.5, placement=True),
], ids=str)
def test_moe_on_the_card_matches_the_cpu(dev, case):
    case = dict(case)
    use_placement = case.pop("placement", False)
    dims = moe.MoEDims(d_model=64, d_ff=32, n_experts=8, top_k=3, **case)
    p = moe.init_moe_params(torch.Generator().manual_seed(0), dims)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 64, 64))
                         .astype(np.float32))
    tables = {}
    if use_placement:
        placement = moe_balance.balance_placement(
            moe_balance.zipf_expert_load(8, 1000, seed=2), 3, slots_per_device=4)
        tables = {d: moe.tables_from_placement(placement, device=d) for d in ("cpu", dev)}
    got = moe.route(_to(p, dev), dims, x.to(dev), tables.get(dev))
    want = moe.route(p, dims, x, tables.get("cpu"))
    for name in ("expert_ids", "slot", "pos", "keep"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    assert got.capacity == want.capacity
    out, aux = moe.moe_forward(_to(p, dev), dims, x.to(dev), tables.get(dev))
    ref, ref_aux = moe.moe_forward(p, dims, x, tables.get("cpu"))
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux), float(ref_aux), atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b"])
def test_reduced_moe_serves_on_the_card_as_on_the_cpu(dev, arch):
    cfg = tcfgs.get_reduced_config(arch)
    params = ttr.init_params(cfg, torch.Generator().manual_seed(0))
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9]]
    tfa.reset_launches()
    toks, logits = ServeEngine(cfg, params, max_seq=32, device=dev).run(prompts, 6)
    assert tfa.LAUNCHES["flash_attention"] == cfg.n_layers
    _, want = ServeEngine(cfg, params, max_seq=32, device="cpu").run(
        prompts, 6, forced=torch.tensor([t[-6:] for t in toks]))
    np.testing.assert_allclose(logits.cpu().numpy(), want.numpy(), atol=2e-3, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_top_k_ties_break_on_the_card_as_on_the_cpu(dev, dtype):
    """Equal router columns and small multiples of 1/2 give exact ties in
    f32 and bf16: the card's expert choices equal the CPU's (the lower
    expert first, as ``lax.top_k``)."""
    dims = moe.MoEDims(d_model=16, d_ff=8, n_experts=8, top_k=2, capacity_factor=64.0)
    p = moe.init_moe_params(torch.Generator().manual_seed(0), dims)
    rng = np.random.default_rng(0)
    router = rng.integers(-2, 3, (16, 8)).astype(np.float32) * 0.5
    router[:, 1], router[:, 5], router[:, 7] = router[:, 0], router[:, 4], router[:, 2]
    p["router"] = torch.from_numpy(router)
    x = torch.from_numpy(rng.integers(-2, 3, (4, 64, 16)).astype(np.float32)).to(dtype)
    want = moe.route(p, dims, x)
    ranked = want.probs.sort(dim=-1, descending=True).values
    assert int((ranked[..., 1] == ranked[..., 2]).sum()) > 10
    got = moe.route(_to(p, dev), dims, x.to(dev))
    assert torch.equal(got.expert_ids.cpu(), want.expert_ids)
    assert torch.equal(got.slot.cpu(), want.slot)
