"""The whole serve step's share of the card's peak, in %: the model FLOPs
of the requests answered in the window (``work.request_flops``: each
layer's dense X·W and sparse product, from shapes) over the window's length
times TF32's 495 TFLOP/s."""

from cardbench import work


def read(run):
    f = run.fields
    if (run.events is None or run.window_s <= 0 or not run.completed_in_window
            or "dims" not in f):
        return None
    flops = run.completed_in_window * work.request_flops(f["n"], f["nnz"], f["dims"])
    return 100.0 * flops / (run.window_s * work.TF32_FLOPS_PER_S)
