"""Device ms of ``forward_batch``'s layout copies a request took in the
window: the device time inside the program's ``executor.layout`` ranges
(each layer's requests column-stacked before its SpMM, and split back
after it) over the requests answered in it."""

from cardbench import spans


def read(run):
    return spans.device_ms_per_request(run, "executor.layout")
