"""The admitted graph's ``Schedule.utilization`` in %: the share of the
equal-work schedule's issued slots that carry a non-zero (the paper's PE
utilization), as ``add_graph`` reports it in its tuned config."""


def read(run):
    return 100.0 * run.schedule_utilization
