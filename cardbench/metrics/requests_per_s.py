"""Requests answered in the window over the window's length (host clock)."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.completed_in_window / run.window_s
