"""The benchmark of the PyTorch and CUDA port, `emosaic_tpu_torch`.

Run one cell from the root of a checkout:

    python bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, reference semantics,
traffic mix or kind, metric or kernel count sits in a file of its own
(`configs/`, `semantics/`, `traffic/`, `metrics/`, `kernels/`), found by
the name `BENCHMARK.json` or a configuration or mix gives it. Nothing here imports `jax` or the JAX package.
"""
