"""The benchmark of linear_operator_tpu_torch: one cell of BENCHMARK.json a run
(``python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace 0|1``)."""
