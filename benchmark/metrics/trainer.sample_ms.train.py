"""The host wall time of the trainer's own `trainer.sample:<phase>` ranges
(the epoch's batches drawn: `sample_epoch`, an alternating epoch's
`sample_kg_epoch`), summed, over the `trainer.epoch` ranges of the
profiled window: the sampling's time an epoch."""


def read(ctx):
    trace = ctx["trace"]
    epochs = trace.ranges("trainer.epoch")
    if not epochs:
        return None
    return 1e3 * sum(e - s for _, s, e, _ in trace.ranges("trainer.sample:")) / len(epochs)
