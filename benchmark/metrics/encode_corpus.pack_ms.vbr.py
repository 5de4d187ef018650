"""ms a call of VBR `batch.encode_corpus`'s host row pack, inside its
assembly (its `encode_pack` stage in `PIPELINE_TIMES`:
`serialize_full_chunks`)."""


def read(ctx):
    return ctx.per_call_ms("encode_pack")
