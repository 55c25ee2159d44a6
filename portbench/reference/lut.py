"""3D-LUT bank file parsing + 48-symmetry-pattern expansion: a frozen
copy of the port's `format/lut.py` (the 3D bank only).

File format (reference `YAIK_private.h:75-80`, writer `EncoderContext.cpp:
7822-7848`, loader `YAIK_API.cpp:133-424`):
  LUTHeader{'LUL0', version, entryCount(=tables-1)} then, for bit in 3..6,
  for each table: x[2^bit], y[2^bit], z[2^bit] u8 (values 0..128).

The decoder expands each table into 48 precomputed patterns
(6 axis swaps x 8 sign flips, flip v -> 128-v) and leaves 16 empty pattern
slots per table (filled 251) so the 14-bit tile type (pattern | lutIdx<<6)
indexes a dense [table*64 + pattern] space with zero bounds checks.

We produce, per bit depth, a numpy u8 array of shape
  [n_tables * 64, 2**bit, 3]
matching the reference layout exactly (interleaved xyz), plus 256 guard
entries appended for parity with the over-allocation (not needed by our
vectorized decode, kept for byte-level comparisons).
"""
from __future__ import annotations

import numpy as np

from portbench.reference.headers import LUTHeader

# swap order (YAIK_API.cpp:292-327): pattern = swap*8 + flip
# swaps map output (x,y,z) from input axes:
_SWAPS = [
    (0, 1, 2),  # XYZ
    (0, 2, 1),  # XZY
    (1, 0, 2),  # YXZ
    (1, 2, 0),  # YZX
    (2, 0, 1),  # ZXY
    (2, 1, 0),  # ZYX
]
# flip order (YAIK_API.cpp:330-409): which of the (post-swap) x,y,z get 128-v
_FLIPS = [
    (False, False, False),
    (True, False, False),
    (False, True, False),
    (True, True, False),
    (False, False, True),
    (True, False, True),
    (False, True, True),
    (True, True, True),
]


def parse_lut_file(data: bytes):
    """Parse a LutFile.lut -> dict bit -> u8 array [n_tables, 2**bit, 3]."""
    if len(data) < LUTHeader.size():
        raise ValueError("LUT file too small")
    hdr = LUTHeader.unpack(data)
    if hdr.tag[:2] != b"LU" or hdr.tag[2:3] != b"L":
        raise ValueError(f"unsupported LUT type {hdr.tag!r}")
    n_tables = hdr.entry_count + 1
    expect = 8 + n_tables * 3 * (8 + 16 + 32 + 64)
    if len(data) != expect:
        raise ValueError(f"LUT file size {len(data)} != expected {expect}")
    out = {}
    off = 8
    for bit in (3, 4, 5, 6):
        n = 1 << bit
        tbl = np.frombuffer(data, np.uint8, n_tables * 3 * n, off)
        out[bit] = tbl.reshape(n_tables, 3, n).transpose(0, 2, 1).copy()
        off += n_tables * 3 * n
    return out


def expand_lut(tables: dict[int, np.ndarray]):
    """48-pattern expansion -> dict bit -> i32 array [n_tables*64, 2**bit, 3].

    Entry values are 0..128 (i32 for direct use in the reconstruction
    arithmetic). Pattern slots 48..63 are the reference's garbage fill (251).
    """
    out = {}
    for bit, tbl in tables.items():
        n_tables, n, _ = tbl.shape
        exp = np.full((n_tables, 64, n, 3), 251, np.int32)
        t = tbl.astype(np.int32)  # [tables, n, 3] xyz
        for s, swap in enumerate(_SWAPS):
            swapped = t[:, :, list(swap)]  # [tables, n, 3]
            for f, flips in enumerate(_FLIPS):
                v = swapped.copy()
                for axis, flip in enumerate(flips):
                    if flip:
                        v[:, :, axis] = 128 - v[:, :, axis]
                exp[:, s * 8 + f] = v
        out[bit] = exp.reshape(n_tables * 64, n, 3)
    return out
