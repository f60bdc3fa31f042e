"""prefill_pass_share (%): prefill chunk passes over all engine passes in
the window (the scheduler's `prefill_chunks` and `decode_steps`)."""


def read(run):
    chunks = run.stats.get("prefill_chunks", 0)
    total = chunks + run.stats.get("decode_steps", 0)
    return 100.0 * chunks / total if total else None
