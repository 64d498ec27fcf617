"""Device ms of the dense X·W products a request took in the window:
cuBLAS's GEMM kernels (by name) over the requests answered in it."""

from cardbench import trace

GEMM = r"gemm|xmma|cutlass"


def read(run):
    if run.events is None or not run.completed_in_window:
        return None
    us, count = trace.matching_us(run.events, GEMM)
    if not count:
        return None
    return us / 1e3 / run.completed_in_window
