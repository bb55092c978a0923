"""Host data pipeline: the window's waits for the next placed K-group of
batches (the harness's span around each fetch from ``prefetch_to_device``)
÷ its train steps, in ms."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("units"):
        return None
    return ctx["data_wait_s"] * 1e3 / ctx["units"]
