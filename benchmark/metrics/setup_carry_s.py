"""Seconds of the program's ``setup.carry`` span on rank 0: the carry's
warmup step, ring and history, pretrain and learner, less the kernels'
build (``setup.kernels``) where it happens inside, so that the first run
in a checkout reads as the others, by the host's clock (see
harness/spans.py)."""

from benchmark.harness import spans


def read(ctx):
    return spans.setup_s(ctx, "setup.carry", less="setup.kernels")
