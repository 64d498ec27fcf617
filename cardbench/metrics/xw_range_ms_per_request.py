"""Device ms of the dense X·W products a request took in the window: the
device time inside the program's ``executor.xw`` ranges (each layer's
per-request products in ``forward_batch``, whatever kernels run them) over
the requests answered in it."""

from cardbench import spans


def read(run):
    return spans.device_ms_per_request(run, "executor.xw")
