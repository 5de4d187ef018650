"""Lanes a `window_search` launch covers in CBR `batch.encode_corpus`: its
`encode_search_lanes_count` counter over `encode_search_launches_count` in
`PIPELINE_TIMES`; None where the program counts no lanes or launched
nothing (the CPU)."""


def read(ctx):
    lanes = ctx.stages.get("encode_search_lanes_count")
    launches = ctx.stages.get("encode_search_launches_count")
    if not lanes or not launches:
        return None
    return lanes / launches
