"""Multi-device and multi-process corpus pipelines: ``pipeline`` (the mesh
of devices, the sharded encode and decode) and ``distributed`` (the
process group and the partition of a corpus's files across processes)."""
