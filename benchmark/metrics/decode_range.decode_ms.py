"""ms a request of `batch.decode_range`'s upload, fused launch, download and
wait for the card (its `range_decode` stage in `PIPELINE_TIMES`)."""


def read(ctx):
    return ctx.per_call_ms("range_decode")
