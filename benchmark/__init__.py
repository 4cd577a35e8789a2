"""The benchmark of tilespmv_tpu_torch on one NVIDIA H100.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once and prints one JSON
line. A cell is a configuration (configs/<name>.json, a matrix made on
the card by generators/<generator>.py) under a traffic mix
(traffic/<name>.json, a solver loop); each metric is read by
metrics/<metric>.py. Nothing here imports JAX or tilespmv_tpu; the
reference (reference.py) imports nothing of the port.
"""
