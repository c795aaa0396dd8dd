"""The frozen data generators: numpy arrays from a seed, parquet through pyarrow.

A generator module exposes `generate(config, seed) -> {table: Generated}`;
the configuration names it under `"generator"`.
"""
