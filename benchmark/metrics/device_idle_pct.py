"""The device's idle share of the traced slots, in %: one minus the union
of every device operation's interval over the traced window's length."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
