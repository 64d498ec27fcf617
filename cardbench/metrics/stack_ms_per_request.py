"""Device ms of the engine's batch assembly a request took in the window:
the device time inside the program's ``gcn_engine.stack`` ranges (a
batch's requests validated and gathered as they came, with no copy) over
the requests answered in it. It reads 0.0 while the assembly launches
nothing on the card; a change that copies a batch again shows here."""

from cardbench import spans


def read(run):
    return spans.device_ms_per_request(run, "gcn_engine.stack")
