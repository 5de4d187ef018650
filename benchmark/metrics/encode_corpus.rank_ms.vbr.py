"""ms a call of VBR `batch.encode_corpus`'s host enqueue of the size
ranking between each chunk index's two searches (its `encode_rank` stage
in `PIPELINE_TIMES`, inside `encode_search`); None where the program
records no such stage."""


def read(ctx):
    return ctx.per_call_ms("encode_rank")
