"""The sparse products' share of their roofline, in %: the least time of
the window's SpMM work (``work.batch_spmm_bound_s``: A once as CSR, B and C
once, at each batch's column-stacked width) over the device time of the
SpMM kernels (``kernels/spmm_cuda``'s window and epilogue, by name)."""

from cardbench import trace, work

SPMM = r"spmm_step_kernel|epilogue_kernel"


def read(run):
    f = run.fields
    if run.events is None or not run.batch_sizes or "dims" not in f:
        return None
    us, count = trace.matching_us(run.events, SPMM)
    if not count:
        return None
    bound = sum(work.batch_spmm_bound_s(f["n"], f["nnz"], f["dims"], b)
                for b in run.batch_sizes)
    return 100.0 * bound / (us / 1e6)
