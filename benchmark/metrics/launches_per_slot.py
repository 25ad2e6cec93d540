"""Kernel launches a slot: the device-only profile's
``cudaLaunchKernel*`` / ``cuLaunchKernel*`` runtime rows, of any thread
(autograd's backward included), that start inside the program's
``loop.slot`` spans, over those slots; the harness's own event records
are no launches (see harness/spans.py)."""

from benchmark.harness import spans


def read(ctx):
    return spans.launches_per_slot(ctx)
