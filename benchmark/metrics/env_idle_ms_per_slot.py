"""Idle device ms a slot while the host is in the program's env step,
state assembly or velocity kicks: idle gaps whose ending operation the
host launched under an ``env.*`` span after the gap began, over the
slots of the device-only profile (see harness/spans.py)."""

from benchmark.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "env")
