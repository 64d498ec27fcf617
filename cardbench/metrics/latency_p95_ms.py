"""The 95th percentile of every answered request's latency, from the moment
its client sent it to the moment its logits were back (host clock), in ms.
Nearest rank: the smallest latency that at least 95 % of requests meet."""

import math


def read(run):
    lat = sorted(run.latencies_s)
    if not lat:
        return None
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
