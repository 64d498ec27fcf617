"""The admitted graph's ``Schedule.utilization`` in %: the share of the
equal-work schedule's issued slots that carry a non-zero (the paper's PE
utilization), as ``add_graph`` reports it in its tuned config."""


def read(run):
    u = run.fields.get("schedule_utilization")
    return None if u is None else 100.0 * u
