"""The benchmark of the PyTorch/CUDA port (`throttlecrab_tpu_torch`):
`python3 -m portbench.run` runs one cell of BENCHMARK.json once.  It
imports neither JAX nor the JAX package."""
