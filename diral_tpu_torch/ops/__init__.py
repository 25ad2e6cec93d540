"""Kernels of the port: CUDA sources in ../csrc, wrappers and plain versions here."""
