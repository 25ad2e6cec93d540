"""Device ms a train event (the learner layer): CUDA events around every
``train_call`` of the window (the window sampler, the gradient steps with
Adam, the target sync), over its events."""


def read(ctx):
    spans = ctx.spans.get("train")
    return sum(spans) / len(spans) if spans else None
