"""PyTorch/CUDA port of the Moebius serving system.

A second package beside the JAX reference `repro`: it imports `torch` and
numpy, never `jax` and nothing of `repro`. Module names mirror `repro` so
each counterpart is found at the same path. Ranks of a layout group live in
one process, stacked on a leading `G` dim (`distributed/ranks.py`); the two
TPU kernels on the serving path are hand-written CUDA C++ for Hopper
(`csrc/`), built with nvcc at first use.
"""
