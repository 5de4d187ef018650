"""A plain reference of the SEA codec (``FORMAT.md``; upstream sea-codec
v0.5.3), in numpy and plain PyTorch operations, for the benchmark's
correctness checks.

It imports nothing of ``sea_codec_torch``, ``sea_codec_tpu`` or JAX, and
takes nothing that the program made: its tables are built here from the
format's definitions, its bit packing and chunk framing are its own, and
its encoder and decoder are straightforward loops over samples, vectorised
only across independent lanes (chunks x channels x candidate scale
factors). Every chunk of a ``.sea`` file carries its own LMS entry state,
so many chunks run side by side.

- ``tables``: scale factors, reciprocals, dequantisation and quantisation
  tables, the VBR target arithmetic (float32-exact).
- ``bits``: MSB-first bit packing of fixed and per-value widths, on tensors.
- ``codec``: chunk layout, serialisation and parsing of full-chunk rows,
  the decoder's recurrence, the encoder's scale-factor search and the VBR
  size assignment.
"""
