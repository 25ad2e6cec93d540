"""Device ms a slot in the acting forward (the nets layer): CUDA events
around every ``TrainFunctions.qvalues`` call of the window, over its
slots."""


def read(ctx):
    spans = ctx.spans.get("act")
    return sum(spans) / ctx.slots if spans and ctx.slots else None
