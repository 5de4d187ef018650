"""`window_search` kernel launches a call of VBR `batch.encode_corpus` (its
`encode_search_launches_count` counter in `PIPELINE_TIMES`; 0 on the CPU,
where no kernel is launched)."""


def read(ctx):
    n = ctx.stages.get("encode_search_launches_count")
    if n is None or not ctx.calls:
        return None
    return n / ctx.calls
