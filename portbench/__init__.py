"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

Run one cell as ``python portbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout; the cells,
metrics and bounds are in ``BENCHMARK.json``.  Nothing here imports
``jax`` or the JAX package ``repro``.
"""
