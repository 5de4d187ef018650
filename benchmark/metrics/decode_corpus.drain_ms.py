"""ms a call of `batch.decode_corpus`'s drain: its `decode_fetch` stage (the
host's waits for each batch's PCM to come down, and the readback of the VBR
fault codes) and its `decode_assemble` stage (the PCM's placement into the
files' outputs that did not overlap the card, and the results) in
`PIPELINE_TIMES`; None where the program records neither."""


def read(ctx):
    if not ctx.calls or not ({"decode_fetch", "decode_assemble"} & set(ctx.stages)):
        return None
    return (ctx.stages.get("decode_fetch", 0.0) + ctx.stages.get("decode_assemble", 0.0)) / ctx.calls * 1e3
