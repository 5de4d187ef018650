"""% of its roofline that `csrc/fused_decode_cbr.cu` reaches (`readers.roofline_pct`)."""

from seabench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "fused_decode_cbr", "fused_decode_cbr_kernel")
