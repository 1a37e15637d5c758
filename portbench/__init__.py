"""portbench: the benchmark of lanpaint_tpu_torch on one NVIDIA H100.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once and prints one JSON
line.  Configurations, traffic mixes, entries and metrics are files found
by name (configs/, workloads/, entries/, metrics/); the plain reference is
reference/.  Nothing here imports JAX or the JAX package."""
