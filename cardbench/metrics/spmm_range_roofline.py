"""The sparse products' share of their roofline, in %: the least time of
the window's SpMM work (``work.batch_spmm_bound_s``: A once as CSR, B and C
once, at each batch's column-stacked width) over the device time inside
the program's ``executor.spmm`` ranges (whatever kernels implement each
layer's product)."""

from cardbench import spans, work


def read(run):
    f = run.fields
    if run.events is None or not run.batch_sizes or "dims" not in f:
        return None
    us = spans.device_us_within(run.events, "executor.spmm")
    if not us:
        return None
    bound = sum(work.batch_spmm_bound_s(f["n"], f["nnz"], f["dims"], b)
                for b in run.batch_sizes)
    return 100.0 * bound / (us / 1e6)
