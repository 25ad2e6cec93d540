"""The lagging rank's host, in ms a train event: for each train event of
the device-only profile, the latest rank's start of its
``parallel.all_reduce`` span minus the earliest's (the ranks share one
host clock), averaged.  Every rank gathers the records (a collective),
so every rank calls this reader (see harness/spans.py)."""

from benchmark.harness import spans


def read(ctx):
    return spans.issue_skew_ms(ctx)
