"""b3_roofline (%): the bound of kernel B3's traced launches (int4 codes,
scales, bf16 x and float32 y over the valid rows at the HBM bandwidth,
or their FLOPs at the bf16 peak where those bound) over their device
time (kernels named gemv launched in B3's entry point)."""
from perfbench import cost, harness


def read(run):
    b = 0.0
    for (m, d_in, d_out, _), (kind, info) in harness.launch_passes(run,
                                                                   "b3"):
        rows = info[1] if kind == "chunk" else len(info)
        b += cost.quant_gemv_bound(min(m, rows), d_in, d_out)
    return harness.roofline_pct(run, b, "b3", "gemv")
