"""ms a request of `batch.decode_range`'s container split (its `range_split`
stage in `PIPELINE_TIMES`: `split_chunks`, the header read and the body
slicing)."""


def read(ctx):
    return ctx.per_call_ms("range_split")
