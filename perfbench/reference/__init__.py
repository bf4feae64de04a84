"""Plain references of the configurations' targets and the comparison that
decides ``correct``: plain PyTorch in float64.  Nothing here imports the
program (``eryn_tpu_torch``), JAX or the JAX package, and nothing takes
what the program made: the inputs are the benchmark's own, and the
program's stored outputs are read only to be judged."""
