"""% of its roofline that `csrc/window_search.cu` reaches in VBR encode (`readers.roofline_pct`)."""

from seabench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "window_search", "window_search_kernel")
