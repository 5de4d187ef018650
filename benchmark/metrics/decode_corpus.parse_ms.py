"""ms a call of `batch.decode_corpus`'s host parse of the containers (its
`decode_parse` stage in `PIPELINE_TIMES`: `container.py` and
`batch.parse_full_chunks`)."""


def read(ctx):
    return ctx.per_call_ms("decode_parse")
