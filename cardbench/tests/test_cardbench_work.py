"""``work.py``'s counts against hand-computed values at reddit's shapes."""

import pytest

from cardbench import work

N, NNZ, F, H, C = 232_965, 22_942_754, 602, 128, 41


def test_dense_and_sparse_flops():
    assert work.dense_flops(N, F, H) == 35_902_702_080
    assert work.spmm_flops(NNZ, H) == 5_873_345_024
    assert work.dense_flops(N, H, C) == 2_445_200_640
    assert work.spmm_flops(NNZ, C) == 1_881_305_828


def test_request_flops_sum_both_layers():
    assert work.request_flops(N, NNZ, [F, H, C]) == (
        35_902_702_080 + 5_873_345_024 + 2_445_200_640 + 1_881_305_828)


def test_spmm_bytes_count_a_b_and_c_once():
    # A: 8 bytes a non-zero + 4 a row pointer; B and C: 4 bytes an element
    assert work.spmm_bytes(N, N, NNZ, 512) == (
        NNZ * 8 + (N + 1) * 4 + N * 512 * 4 + N * 512 * 4)
    assert work.spmm_bytes(N, N, NNZ, 512) == 1_138_698_536


def test_bound_is_bytes_at_reddits_widths_and_flops_when_dense():
    assert work.spmm_bound_s(N, N, NNZ, 512) == pytest.approx(1_138_698_536 / 3.35e12)
    # a dense enough A is bound by its operations
    n = 2048
    assert work.spmm_bound_s(n, n, n * n, n) == pytest.approx(2 * n * n * n / 495e12)


def test_batch_bound_stacks_the_requests():
    got = work.batch_spmm_bound_s(N, NNZ, [F, H, C], 4)
    assert got == pytest.approx(work.spmm_bound_s(N, N, NNZ, 512)
                                + work.spmm_bound_s(N, N, NNZ, 164))
    assert 0.45e-3 < got < 0.5e-3
