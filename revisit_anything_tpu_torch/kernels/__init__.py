"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``), their build and
their launch counters. See ``build.py``."""
