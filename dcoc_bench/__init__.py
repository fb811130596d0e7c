"""The benchmark of ``repro_torch`` on an NVIDIA H100: one cell a run,
``python3 dcoc_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout.  See README.md."""
