"""PyTorch/CUDA port of diral_tpu for NVIDIA Hopper.

A second package beside ``diral_tpu`` (the JAX reference, unchanged):
the same configs and semantics, with every TPU kernel on a ported path
rewritten as a hand-written CUDA kernel (``csrc/``), each beside its plain
PyTorch version.  It imports torch, numpy and yaml, never JAX nor any
module of ``diral_tpu``.
"""
