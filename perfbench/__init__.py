"""The serving benchmark of `repro_torch` on one NVIDIA H100.

`python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` serves one cell of `BENCHMARK.json` through
`repro_torch.serving.api.KVNANDServer` and prints one JSON result line.
See README.md in this directory.
"""
