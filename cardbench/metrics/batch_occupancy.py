"""Requests per batch the engine served in the window (its ``batches`` and
``requests`` counters): how full ``serving/gcn_engine``'s batching keeps
each forward."""


def read(run):
    if not run.batch_sizes:
        return None
    return sum(run.batch_sizes) / len(run.batch_sizes)
