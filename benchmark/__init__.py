"""The benchmark of myosuite_tpu_torch on NVIDIA H100 cards.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of the repository's BENCHMARK.json and prints
one JSON line. Everything a cell needs is found by name: its configuration
in `configs/<config>.json` (its reference task in
`reference/tasks/<task>.py`), its traffic mix in `traffic/<traffic>.json`
(the code of the traffic's kind in `kinds/<kind>.py`), the limits of its
output check in `limits/<cell>.json`, and each per-layer metric's reader
in `metrics/<metric>.py`.
"""
