"""output_tok_s: every output token that reached the host in the window,
over the window's seconds (host clock); tokens of requests still running
at the window's end count."""


def read(run):
    return sum(s.tokens for s in run.steps) / run.window_s
