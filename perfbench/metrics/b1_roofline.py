"""b1_roofline (%): the bound of kernel B1's traced launches (each row's
cached keys and values, q, o, m and l at the HBM bandwidth) over their
device time (kernels named paged_attention launched in B1's entry
point)."""
from perfbench import cost, harness


def read(run):
    b = sum(cost.paged_attention_bound(run.model, [c for c, _, _ in rows])
            for _, (kind, rows) in harness.launch_passes(run, "b1")
            if kind == "decode")
    return harness.roofline_pct(run, b, "b1", "paged_attention")
