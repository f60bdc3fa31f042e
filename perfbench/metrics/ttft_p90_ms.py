"""ttft_p90_ms: 90th percentile, over every request whose first token
arrived in the window, of submit to first token (host clock)."""
from perfbench import harness


def read(run):
    return harness.percentile(harness.ttft_ms(run), 90)
