"""Device ms a slot in the env layer: CUDA events from the call of the
env step to the end of ``obtain_state`` (the next state's assembly),
every slot of the window, over its slots."""


def read(ctx):
    spans = ctx.spans.get("env")
    return sum(spans) / ctx.slots if spans and ctx.slots else None
