"""The whole serve step's share of the card's peak, in %: the model FLOPs
of the requests answered in the window (``work.request_flops``: each
layer's dense X·W and sparse product, from shapes) over the window's length
times TF32's 495 TFLOP/s."""

from cardbench import work


def read(run):
    if run.events is None or run.window_s <= 0 or not run.completed_in_window:
        return None
    flops = run.completed_in_window * work.request_flops(run.n, run.nnz, run.dims)
    return 100.0 * flops / (run.window_s * work.TF32_FLOPS_PER_S)
