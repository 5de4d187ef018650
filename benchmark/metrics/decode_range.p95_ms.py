"""95th percentile of the traced window's `batch.decode_range` requests, ms
(`readers.p95_ms`): the tail of the seek host path."""

from seabench.readers import p95_ms as read  # noqa: F401
