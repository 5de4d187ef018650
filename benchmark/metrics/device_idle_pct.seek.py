"""% of the traced seek window with nothing on the card (`readers.idle_pct`)."""

from seabench.readers import idle_pct as read  # noqa: F401
