"""ms a call of VBR `batch.encode_corpus`'s host assembly of the containers
(its `encode_assemble` stage in `PIPELINE_TIMES`)."""


def read(ctx):
    return ctx.per_call_ms("encode_assemble")
