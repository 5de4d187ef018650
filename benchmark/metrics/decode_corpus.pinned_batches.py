"""Batches a call of `batch.decode_corpus` brings down through pinned host
memory on its side stream (its `decode_pinned_batches_count` counter in
`PIPELINE_TIMES`); None where the program has no such counter or it reads
0 (the CPU)."""


def read(ctx):
    n = ctx.stages.get("decode_pinned_batches_count")
    if not n or not ctx.calls:
        return None
    return n / ctx.calls
