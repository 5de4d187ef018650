"""ms a request of `batch.decode_range`'s host parse of the chunks the range
touches (its `range_parse` stage in `PIPELINE_TIMES`)."""


def read(ctx):
    return ctx.per_call_ms("range_parse")
