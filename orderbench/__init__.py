"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

Run one cell with ``python orderbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the repository's root; ``BENCHMARK.json``
names the cells.  Nothing here imports JAX or the JAX package.
"""
