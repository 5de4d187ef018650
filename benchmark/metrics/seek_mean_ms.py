"""The mean wait of a `batch.decode_range` request: the window's time over
its requests, ms (`readers.mean_ms`)."""

from seabench.readers import mean_ms as read  # noqa: F401
