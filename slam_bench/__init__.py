"""The benchmark of the PyTorch and CUDA port ``sdvl_tpu_torch`` on one
NVIDIA H100: ``python3 -m slam_bench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.
See ``PERF.md`` for the cells, metrics and limits."""
