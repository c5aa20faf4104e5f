"""The benchmark of meshfem_tpu_torch on one NVIDIA H100.  Run a cell with
``python3 fembench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` from the repository's root; ``BENCHMARK.json`` lists the
cells and metrics."""
