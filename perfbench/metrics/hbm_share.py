"""hbm_share (%): the bytes the window's passes need (`cost.py`: each
weight byte once a pass, each distinct cached position read once a
pass, new keys and values written once), over the window times the
card's HBM bandwidth."""
from perfbench import cost


def read(run):
    nbytes = sum(b for _, b in run.passes(run.steps))
    return 100.0 * nbytes / (run.window_s * cost.HBM_BW) or None
