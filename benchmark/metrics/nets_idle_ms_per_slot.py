"""Idle device ms a slot that the program's acting forward held: the
device-only profile's idle gaps whose ending operation the host launched
after the gap began, under a ``nets.*`` span of the loop's thread, over
the slots of the profile; a gap whose operation was queued before it is
in no layer (see harness/spans.py)."""

from benchmark.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "nets")
