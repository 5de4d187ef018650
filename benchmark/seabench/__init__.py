"""The benchmark harness of ``sea_codec_torch``, driven by ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``benchmark/configs/<config>.json``: the stream layout and where it comes
  from; the plain reference of it is ``benchmark/reference/``.
- ``benchmark/traffic/<traffic>.json``: the mix's parameters, read by the one
  generator (``traffic.py``).
- ``benchmark/entries/<entry>.py``: the driver (``Entry``) of the program's
  entry that a mix names: how it is called, warmed up and checked, and
  the roofline work of its calls (``driver.py`` holds what they share).
- ``benchmark/metrics/<metric>.py``: a reader with ``read``, of the run's
  driver for an end-to-end metric and of the traced window
  (``trace.Context``) for a per-layer one; it returns None where it finds
  nothing to read (``readers.py`` holds what they share).

``harness.run_cell`` runs one cell: set-up (kernels from the build cache,
traffic from the seed, one warm-up call of the cell's shape, a mesh of the
cell's cards for an entry that takes one), the measured window, the check
against the reference, and the result line.
"""
