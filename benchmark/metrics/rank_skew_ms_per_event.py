"""The lagging rank, in device ms a train event: the largest minus the
smallest rank's NCCL kernel time a train event (see
allreduce_ms_per_event): the wait that the slowest rank's host or device
imposes on the others."""


def read(ctx):
    ms = [m for m in (ctx.nccl_ms_per_event or []) if m is not None]
    return max(ms) - min(ms) if len(ms) > 1 else None
