"""Device ms of the gradient all-reduce a train event across the data
mesh, on the rank that waits least: per rank, the NCCL kernels of the
device-only profile (kernel rows only, not the collective's range on the
device's timeline) over the train events in its traced slots; the least
over the ranks, since a rank's NCCL kernel also spans its wait for the
slowest rank."""


def read(ctx):
    ms = [m for m in (ctx.nccl_ms_per_event or []) if m is not None]
    return min(ms) if ms else None
