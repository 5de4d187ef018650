"""Msamples/s of VBR `batch.encode_corpus` over the window (`Driver.rate_msamples_s`)."""


def read(drv):
    return drv.rate_msamples_s()
