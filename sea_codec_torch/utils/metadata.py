"""Structured metadata: the spec's key=value conventions.

The .sea header reserves ``metadata_size`` UTF-8 bytes (reference
``README.md:71-84``); the spec defines their *structure* too
(``README.md:73-77``): newline-separated ``key=value`` pairs where the key
is case-insensitive and may not contain ``=`` or ``\\n``, and the value is
case-sensitive and may contain anything except ``\\n``. The reference never
ships a parser for this structure (its own header parser does not even
consume the bytes, ``file.rs:53-55``); these helpers implement the written
spec so CLI users and library callers get dict-shaped metadata instead of a
raw string.
"""

from __future__ import annotations

from ..utils.errors import SeaError


def format_metadata(pairs: dict[str, str]) -> str:
    """Serialize ``pairs`` to the header's metadata string.

    Keys are validated per the spec (non-empty, no ``=`` or newline) and
    stored as given -- the spec makes *comparison* case-insensitive, not
    storage. Values may not contain newlines. Returns ``""`` for an empty
    dict (written as metadata_size=0, reference ``file.rs:66-69``).
    """
    out = []
    seen: set[str] = set()
    for key, value in pairs.items():
        if not isinstance(key, str) or not isinstance(value, str):
            raise SeaError("metadata keys and values must be str")
        if not key or "=" in key or "\n" in key:
            raise SeaError(
                f"invalid metadata key {key!r}: must be non-empty and "
                "contain no '=' or newline (README.md:76)"
            )
        if "\n" in value:
            raise SeaError(
                f"invalid metadata value for {key!r}: newlines are the "
                "pair separator (README.md:74)"
            )
        folded = key.casefold()
        if folded in seen:
            raise SeaError(
                f"duplicate metadata key {key!r} (keys compare "
                "case-insensitively, README.md:76)"
            )
        seen.add(folded)
        out.append(f"{key}={value}")
    return "\n".join(out) + ("\n" if out else "")


def parse_metadata(text: str, *, strict: bool = False) -> dict[str, str]:
    """Parse a header metadata string into ``{key: value}``.

    Keys keep their written spelling but later duplicates (compared
    case-insensitively per the spec) are rejected. Lines without ``=`` are
    malformed; ``strict=True`` raises on them, the default skips them --
    lenient because arbitrary writers exist and the reference itself never
    validates this region.
    """
    pairs: dict[str, str] = {}
    folded: set[str] = set()
    for line in text.split("\n"):
        if not line:
            continue
        key, sep, value = line.partition("=")
        if not sep or not key:
            if strict:
                raise SeaError(f"malformed metadata line {line!r}")
            continue
        f = key.casefold()
        if f in folded:
            if strict:
                raise SeaError(f"duplicate metadata key {key!r}")
            continue
        folded.add(f)
        pairs[key] = value
    return pairs


def lookup_metadata(pairs: dict[str, str], key: str) -> str | None:
    """Case-insensitive key lookup per README.md:76."""
    f = key.casefold()
    for k, v in pairs.items():
        if k.casefold() == f:
            return v
    return None
