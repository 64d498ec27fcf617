"""The plain reference against a dense ``A @ (X @ W)``, and its control."""

import numpy as np
import pytest
import torch

from cardbench import control, gen, reference
from cardbench.tests import helpers


def _dense(rows, cols, vals, n):
    a = torch.zeros((n, n), dtype=torch.float64)
    a[torch.from_numpy(rows), torch.from_numpy(cols)] = torch.from_numpy(vals).double()
    return a


@pytest.mark.parametrize("block", [reference.BLOCK_NNZ, 97])
def test_reference_matches_the_dense_product(block):
    n, f, h, c = 200, 24, 16, 5
    rows, cols, vals = gen.power_law_adjacency(n, 0.02, 0.8, seed=1, max_degree=30)
    g = torch.Generator().manual_seed(0)
    x = torch.rand((n, f), generator=g)
    w0, w1 = torch.randn((f, h), generator=g), torch.randn((h, c), generator=g)
    r, co, v = torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(vals)
    a = _dense(rows, cols, vals, n)
    want = a @ torch.relu(a @ (x.double() @ w0.double())) @ w1.double()
    if block == reference.BLOCK_NNZ:
        got = reference.gcn_logits(r, co, v, n, x, [w0, w1])
    else:
        h1 = torch.relu(reference.spmm(r, co, v, n, x @ w0, block=block))
        got = reference.spmm(r, co, v, n, h1 @ w1, block=block)
    assert reference.rel_err(got, want.float()) < 1e-6


def test_rel_err_flags_shape_and_nonfinite():
    ref = torch.ones((3, 2))
    assert reference.rel_err(ref.clone(), ref) == 0.0
    assert reference.rel_err(torch.ones((2, 3)), ref) == float("inf")
    bad = ref.clone()
    bad[0, 0] = float("nan")
    assert reference.rel_err(bad, ref) == float("inf")
    assert reference.rel_err(ref * 1.01, ref) == pytest.approx(0.01, rel=1e-5)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12, -3.0000002])
    got = helpers.round_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0, -3.0]
    bits = got.view(torch.int32).numpy()
    assert np.all(bits & 0x1FFF == 0)


def test_the_reference_runs_with_tf32_off_whatever_the_caller_allowed():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        seen = []
        orig = torch.Tensor.__matmul__

        def matmul(a, b):
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            return orig(a, b)

        torch.Tensor.__matmul__ = matmul
        try:
            reference.dense(torch.ones((2, 3)), torch.ones((3, 2)))
        finally:
            torch.Tensor.__matmul__ = orig
        assert seen == [False]
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 3])
def test_control_fails_the_limit_that_the_reference_meets(tmp_path, monkeypatch, seed):
    """The control, the program with its TF32 path on (emulated on the CPU,
    which has no TF32, by rounding X·W's operands), comes out not correct
    through the harness's own check at a small size; the program as stated
    comes out correct on the same seed."""
    root = helpers.tiny_root(tmp_path)
    program = control.reading(helpers.CELL, seed, 0.3, False, root=root, device="cpu")
    assert program["correct"] and program["logits_rel_err"] < program["limit"] / 3
    helpers.emulate_tf32(monkeypatch)
    ctrl = control.reading(helpers.CELL, seed, 0.3, True, root=root, device="cpu")
    assert ctrl["correct"] is False
    assert ctrl["logits_rel_err"] > 3 * ctrl["limit"] and ctrl["failed"] == 0
