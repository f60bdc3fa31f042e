"""step_ms: the window over the scheduler steps in it (host clock)."""


def read(run):
    return 1e3 * run.window_s / len(run.steps) if run.steps else None
