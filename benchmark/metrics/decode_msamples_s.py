"""Msamples/s of `batch.decode_corpus` over the window (`Driver.rate_msamples_s`)."""


def read(drv):
    return drv.rate_msamples_s()
