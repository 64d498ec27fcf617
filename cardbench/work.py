"""Operations and bytes of the GCN's work, from shapes, and the card's peaks.

The yardstick of the roofline and ``mfu`` metrics. It counts the work a
layer has to do, not what a kernel happens to read: the sparse product
reads A once as CSR (a 4-byte column index and a 4-byte value a non-zero,
and the row pointers), the dense operand B once and writes C once. A later
change to the schedule or to the kernels' records does not move it.

Peaks: NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power
limit. The FLOP peak is TF32's on the tensor cores, not f32's 67 TFLOP/s on
the CUDA cores: a 3xTF32 product meets the f32 tolerance, so no legal
change can run faster than 495 TFLOP/s, while 67 can be passed.
"""

from __future__ import annotations

from typing import Sequence

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS_PER_S = 495e12
F32_BYTES = 4
INDEX_BYTES = 4


def dense_flops(rows: int, inner: int, cols: int) -> int:
    """FLOPs of a dense ``[rows, inner] @ [inner, cols]`` product."""
    return 2 * rows * inner * cols


def spmm_flops(nnz: int, k: int) -> int:
    """FLOPs of ``A @ B`` with ``nnz`` non-zeros and ``k`` columns of B."""
    return 2 * nnz * k


def spmm_bytes(m: int, n: int, nnz: int, k: int) -> int:
    """Least bytes of ``A[m, n] @ B[n, k]`` in f32: A as CSR once, B once,
    C once."""
    a = nnz * (INDEX_BYTES + F32_BYTES) + (m + 1) * INDEX_BYTES
    return a + n * k * F32_BYTES + m * k * F32_BYTES


def spmm_bound_s(m: int, n: int, nnz: int, k: int) -> float:
    """The least time one such product can take on the card."""
    return max(spmm_bytes(m, n, nnz, k) / HBM_BYTES_PER_S,
               spmm_flops(nnz, k) / TF32_FLOPS_PER_S)


def request_flops(n: int, nnz: int, dims: Sequence[int]) -> int:
    """Model FLOPs of one request's forward pass, A·(X·W) per layer:
    the dense X·W and the sparse product, for ``dims = [features, hidden,
    ..., classes]`` over a graph of ``n`` nodes and ``nnz`` non-zeros."""
    return sum(dense_flops(n, d_in, d_out) + spmm_flops(nnz, d_out)
               for d_in, d_out in zip(dims[:-1], dims[1:]))


def batch_spmm_bound_s(n: int, nnz: int, dims: Sequence[int], batch: int) -> float:
    """The least time of one batch's sparse products: one per layer, on
    the requests' column-stacked ``[n, batch · d_out]`` operand."""
    return sum(spmm_bound_s(n, n, nnz, batch * d_out) for d_out in dims[1:])
