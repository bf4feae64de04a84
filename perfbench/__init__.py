"""The benchmark of eryn_tpu_torch on one NVIDIA GPU (``perfbench/run.py``).

Everything one configuration, traffic mix or per-layer metric needs lives in
files of its own, found by the names ``BENCHMARK.json`` gives them (see
``README.md``).  Nothing here imports JAX or the JAX package.
"""
