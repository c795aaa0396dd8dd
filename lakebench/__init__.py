"""lakebench: the benchmark of hyperspace_tpu_torch on one NVIDIA GPU.

`python3 lakebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once; `README.md` says how the cells, the
configurations, the traffic mixes, the queries and the metrics are laid out.
Nothing here imports jax or the JAX package.
"""
