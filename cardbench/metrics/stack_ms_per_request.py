"""Device ms of the engine's batch copy a request took in the window: the
device time inside the program's ``gcn_engine.stack`` ranges (the
``torch.stack`` of a batch's requests into one operand) over the requests
answered in it."""

from cardbench import spans


def read(run):
    return spans.device_ms_per_request(run, "gcn_engine.stack")
