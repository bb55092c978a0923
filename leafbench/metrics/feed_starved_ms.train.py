"""Host data pipeline: Σ wall ms of the port's
``leaf_tpu_torch.feed.starved`` spans in the window (the consumer's waits
on an empty ``prefetch_to_device`` queue: the loader was late) ÷ train
steps; 0 where the program records spans but never waited."""

from leafbench.measure import phases


def read(ctx):
    return phases.span_ms(ctx, "train", phases.STARVED)
