"""ALTO sparse tensor decomposition in PyTorch with hand-written CUDA
kernels for Hopper — the port of the JAX package `repro`, which stays the
reference. Layout mirrors it: `sparse/`, `core/`, `kernels/`."""
