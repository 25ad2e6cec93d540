"""Idle device ms a slot that the loop's own work held: idle gaps whose
ending operation the host launched after the gap began, under a
``loop.*`` or ``runner.*`` span (``loop.slot``'s self time included:
the schedules, the action selection, shaping, the replay add, the
history push), over the slots of the device-only profile (see
harness/spans.py)."""

from benchmark.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "loop")
