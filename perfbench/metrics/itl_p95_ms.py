"""itl_p95_ms: 95th percentile of every inter-token gap of every request
inside the window (host clock, arrival to arrival)."""
from perfbench import harness


def read(run):
    return harness.percentile(harness.itl_ms(run), 95)
