"""batch_occupancy (%): decode tokens over decode passes x slots in the
window (the scheduler's `decode_tokens` and `decode_steps` counters)."""


def read(run):
    steps = run.stats.get("decode_steps", 0)
    if not steps:
        return None
    return 100.0 * run.stats["decode_tokens"] / (steps * run.slots)
