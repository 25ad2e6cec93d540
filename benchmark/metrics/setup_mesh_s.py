"""Seconds of the program's ``setup.process_group`` span on rank 0: the
rendezvous store, the exchange of host names and card counts, and the
process group's start (NCCL's communicator) (see harness/spans.py)."""

from benchmark.harness import spans


def read(ctx):
    return spans.setup_s(ctx, "setup.process_group")
