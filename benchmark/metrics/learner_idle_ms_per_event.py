"""Idle device ms a train event while the host is in the program's
learner (the window sampler with its all-reduce, the gradient steps,
the target sync): idle gaps whose ending operation the host launched
after the gap began, under a ``learner.*`` span or a ``parallel.*`` span
inside one, over the train events of the device-only profile (see
harness/spans.py)."""

from benchmark.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "learner")
