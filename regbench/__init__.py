"""regbench: the benchmark of `saccot_tpu_torch`, the port's registration
estimator on one H100. `python -m regbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` runs one cell once (see `run.py`); the cells,
configurations and metrics are named in `BENCHMARK.json` at the repository
root and defined by the files under this directory."""
