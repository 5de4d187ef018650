"""MSB-first bit packing/unpacking, vectorized in numpy (host side).

Semantics match the reference bit packer/unpacker exactly
(``src/codec/bits.rs``): values of 1..8 bits are concatenated MSB-first into
a byte stream; the final partial byte is left-aligned (zero-padded on the
right). Unpacking extracts as many whole items as the provided byte count
allows (constant width) or exactly the provided per-item widths (variable
width, used for VBR residuals), discarding trailing pad bits.

Instead of the reference's streaming byte loop, both directions are
formulated as rectangular bit-matrix shuffles (expand-to-bits -> gather ->
fold).
"""

from __future__ import annotations

import numpy as np

from ..utils.errors import SeaInvalidFrame


def pack_bits(values: np.ndarray, widths: np.ndarray | int) -> np.ndarray:
    """Pack ``values[i]`` into ``widths[i]`` bits, MSB-first. Returns uint8[].

    ``widths`` may be a scalar (constant width) or a per-item array.
    Matches BitPacker::push/finish (reference src/codec/bits.rs:104-134).
    """
    values = np.asarray(values, dtype=np.uint32)
    n = values.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.uint8)
    if np.isscalar(widths) or np.ndim(widths) == 0:
        widths = np.full(n, int(widths), dtype=np.int64)
    else:
        widths = np.asarray(widths, dtype=np.int64)
        assert widths.shape[0] == n

    # bit j (MSB-first) of item i sits at column (8 - w_i + j) of an 8-wide
    # matrix; equivalently column k holds bit (w_i - 1 - (k - (8 - w_i))).
    shifts = np.arange(7, -1, -1, dtype=np.uint32)  # col k -> shift 7-k
    bits8 = (values[:, None] >> shifts[None, :]) & 1  # [n, 8], MSB-first of 8-bit view
    # item i contributes its w_i lowest significance bits, i.e. columns
    # (8 - w_i) .. 7 of bits8.
    col = np.arange(8, dtype=np.int64)
    valid = col[None, :] >= (8 - widths)[:, None]  # [n, 8]
    flat_bits = bits8.reshape(-1)[valid.reshape(-1)]
    return np.packbits(flat_bits.astype(np.uint8), bitorder="big")


def unpack_bits(data: np.ndarray, widths: np.ndarray | int, count: int | None = None) -> np.ndarray:
    """Unpack a MSB-first bitstream into items. Returns uint8[].

    - Constant width (``widths`` scalar): extracts ``floor(len(data)*8 / w)``
      items, or ``count`` if given (must not exceed that bound). Matches
      BitUnpacker::new_const_bits/process_bytes_const (src/codec/bits.rs:12,34).
    - Variable widths (array): extracts exactly ``len(widths)`` items; the
      stream must contain at least ``sum(widths)`` bits. Matches
      new_var_bits/process_bytes_variable (src/codec/bits.rs:22,52).
    """
    data = np.asarray(data, dtype=np.uint8)
    total_bits = data.shape[0] * 8
    if np.isscalar(widths) or np.ndim(widths) == 0:
        w = int(widths)
        n = total_bits // w
        if count is not None:
            if count > n:
                raise SeaInvalidFrame(
                    f"bitstream too short: {count} items of {w} bits from "
                    f"{total_bits} bits"
                )
            n = count
        if n == 0:
            return np.zeros(0, dtype=np.uint8)
        # Constant width: item i occupies bits [i*w, (i+1)*w) -- a plain
        # reshape of the bit expansion, no gather/mask needed.
        bits = np.unpackbits(data, bitorder="big", count=n * w)
        folded = bits.reshape(n, w) << np.arange(w - 1, -1, -1, dtype=np.uint8)
        return folded.sum(axis=1, dtype=np.uint8)
    else:
        widths = np.asarray(widths, dtype=np.int64)
        n = widths.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.uint8)

    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(widths[:-1], out=offsets[1:])
    if offsets[-1] + widths[-1] > total_bits:
        raise SeaInvalidFrame(
            f"bitstream too short: need {int(offsets[-1] + widths[-1])} bits, "
            f"have {total_bits}"
        )

    bits = np.unpackbits(data, bitorder="big").astype(np.uint32)
    # item i = fold of bits[offsets[i] .. offsets[i]+w_i), MSB-first.
    j = np.arange(8, dtype=np.int64)
    idx = offsets[:, None] + j[None, :]  # [n, 8]
    valid = j[None, :] < widths[:, None]
    idx = np.where(valid, idx, 0)
    gathered = bits[idx]  # [n, 8]
    shift = np.where(valid, widths[:, None] - 1 - j[None, :], 0).astype(np.uint32)
    vals = np.sum(np.where(valid, gathered << shift, 0), axis=1, dtype=np.uint32)
    return vals.astype(np.uint8)


def unpack_bits_rows(data: np.ndarray, widths: np.ndarray | int, count: int) -> np.ndarray:
    """Unpack each row of ``data`` [N, B] into ``count`` items -> uint8[N, count].

    ``widths`` is a scalar (same layout for every row) or [N, count] per-row
    widths (VBR residuals: every chunk has its own window sizes). This is the
    rectangular batch formulation used by the corpus decode pipeline: all full
    chunks of a ``.sea`` file share identical section layouts, so one
    unpackbits + one gather handles the whole batch.
    """
    data = np.asarray(data, dtype=np.uint8)
    n, b = data.shape
    if count == 0:
        return np.zeros((n, 0), dtype=np.uint8)
    if np.isscalar(widths) or np.ndim(widths) == 0:
        w = int(widths)
        if count * w > b * 8:
            raise SeaInvalidFrame(
                f"bitstream too short: need {count * w} bits, have {b * 8}"
            )
        # Constant width: contiguous w-bit fields -- reshape the bit
        # expansion, no gather/mask needed.
        bits = np.unpackbits(data, axis=1, bitorder="big")[:, : count * w]
        folded = bits.reshape(n, count, w) << np.arange(
            w - 1, -1, -1, dtype=np.uint8
        )
        return folded.sum(axis=2, dtype=np.uint8)
    bits = np.unpackbits(data, axis=1, bitorder="big").astype(np.uint32)  # [N, B*8]
    j = np.arange(8, dtype=np.int64)
    widths = np.asarray(widths, dtype=np.int64)
    assert widths.shape == (n, count)
    offsets = np.zeros((n, count), dtype=np.int64)
    np.cumsum(widths[:, :-1], axis=1, out=offsets[:, 1:])
    idx = offsets[:, :, None] + j[None, None, :]  # [N, count, 8]
    valid = j[None, None, :] < widths[:, :, None]
    idx = np.where(valid, idx, 0)
    gathered = np.take_along_axis(bits, idx.reshape(n, -1), axis=1).reshape(n, count, 8)
    shift = np.where(valid, widths[:, :, None] - 1 - j[None, None, :], 0).astype(np.uint32)
    vals = np.sum(np.where(valid, gathered << shift, 0), axis=2, dtype=np.uint32)
    return vals.astype(np.uint8)


def pack_bits_rows(values: np.ndarray, widths: np.ndarray | int) -> np.ndarray:
    """Pack each row of ``values`` [N, count] -> uint8[N, row_bytes].

    ``widths`` is a scalar or [N, count]; with per-row widths, every row must
    pack to the same total bit count (true for the batch encoder: full chunks
    share section lengths). Vectorized mirror of ``pack_bits``.
    """
    values = np.asarray(values, dtype=np.uint32)
    n, count = values.shape
    j = np.arange(8, dtype=np.int64)
    bits8 = (values[:, :, None] >> (7 - j)[None, None, :].astype(np.uint32)) & 1
    if np.isscalar(widths) or np.ndim(widths) == 0:
        w = int(widths)
        flat = bits8[:, :, 8 - w :].reshape(n, count * w)
        return np.packbits(flat.astype(np.uint8), axis=1, bitorder="big")
    widths = np.asarray(widths, dtype=np.int64)
    valid = j[None, None, :] >= (8 - widths)[:, :, None]  # [N, count, 8]
    total = int(widths[0].sum())
    if not np.all(widths.sum(axis=1) == total):
        raise ValueError("rows must share total bit count")
    flat = bits8.reshape(n, -1)[valid.reshape(n, -1)].reshape(n, total)
    return np.packbits(flat.astype(np.uint8), axis=1, bitorder="big")


def packed_byte_len(widths: np.ndarray | int, count: int | None = None) -> int:
    """Number of bytes produced by packing ``count`` items of given widths."""
    if np.isscalar(widths) or np.ndim(widths) == 0:
        assert count is not None
        total = int(widths) * count
    else:
        total = int(np.sum(np.asarray(widths, dtype=np.int64)))
    return (total + 7) // 8
