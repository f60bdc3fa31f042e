"""mfu (%): the FLOPs of every prompt and output token processed in the
window (`cost.py`: 2 a weight multiplied, 2 V D a row of logits, 4 H dh
a scored pair), over the window times the card's dense bf16 peak."""
from perfbench import cost


def read(run):
    flops = sum(f for f, _ in run.passes(run.steps))
    return 100.0 * flops / (run.window_s * cost.PEAK_FLOPS) or None
