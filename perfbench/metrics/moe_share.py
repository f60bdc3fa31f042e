"""moe_share (%): device time of the kernels launched inside
`models/layers.py` `moe` over the device's busy time, in the traced
steps with ranges."""


def read(run):
    tr = run.trace
    if tr is None or tr.ranges_busy_s <= 0:
        return None
    t = tr.time_in("moe")
    return 100.0 * t / tr.ranges_busy_s if t > 0 else None
