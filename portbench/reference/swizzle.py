"""Tile-bitmap swizzle spec + scan-order enumeration: a frozen copy of
the port's `format/swizzle.py`.

The encoder and decoder must agree on (a) how accepted-tile bitmaps are laid
out (big-tile words, LSB-first bits) and (b) the order tiles are visited,
because every per-tile stream (corner RGB, 3D color/type/index, 1D triplets)
is consumed in that scan order.

Mirrors reference `include/YAIK_private.h:212-276` (HeaderGradientTile::
getSwizzleSize) and the traversal loops in `decoder/YAIK_Gradient.cpp` /
`decoder/YAIK_3DTile.cpp`:

  - image is walked in big tiles of (BX, BY) pixels, row-major;
  - each big tile owns one bitmap word of (BX/tw)*(BY/th) bits;
  - within a word, bits are row-major over tiles, LSB-first
    (bit = tileRow * colsPerBig + tileCol);
  - words are u16/u32/u64 little-endian, so the bitmap is equivalent to one
    flat little-endian bitstream.

Claim map ("tile4x4Mask", 1 bit per 4x4 quad): bytes in a
[ceil(h/8), ceil(w/16)] grid, each byte covering 16x8 px; within a byte,
bit(qx, qy) = (qx & 1) + 2*qy + 4*(qx >> 1)   (qx 0..3, qy 0..1)
(derived from the claim updates in YAIK_Gradient.cpp:156,356,554,754,953,1380
and YAIK_3DTile.cpp:571,719,1452-1460,1797-1809,2033-2048).
"""
from __future__ import annotations

import numpy as np

# (shift_x, shift_y) -> (bigX, bigY) ; bitCount = (bigX>>sx)*(bigY>>sy)
_SWIZZLE = {
    (4, 4): (64, 64),
    (4, 3): (64, 64),
    (3, 4): (64, 64),
    (3, 3): (64, 64),
    (3, 2): (64, 32),
    (2, 3): (32, 64),
    (2, 2): (32, 32),
}

# Pass order of tile sizes inside a 3DTL chunk (YAIK_API.cpp:1106-1285) and
# the gradient chunk emission order (EncoderContext.cpp:9057-9093) both use
# (shift_x, shift_y) pairs.
GRADIENT_PASS_ORDER = [(4, 4), (4, 3), (3, 4), (3, 3), (3, 2), (2, 3), (2, 2)]
TILE3D_PASS_ORDER = [(4, 3), (3, 4), (3, 3), (3, 2), (2, 3), (2, 2)]


def swizzle_spec(sx: int, sy: int):
    """Return (bigX, bigY, bits_per_word) for a tile shape (1<<sx, 1<<sy)."""
    if (sx, sy) not in _SWIZZLE:
        raise ValueError(f"invalid tile format shift ({sx},{sy})")
    bx, by = _SWIZZLE[(sx, sy)]
    return bx, by, (bx >> sx) * (by >> sy)


def bitmap_size_bytes(sx: int, sy: int, w: int, h: int) -> int:
    """Uncompressed bitmap byte size (HeaderGradientTile::getBitmapSwizzleSize)."""
    bx, by, bits = swizzle_spec(sx, sy)
    return ((w + bx - 1) // bx) * ((h + by - 1) // by) * bits // 8


_SCAN_COORD_CACHE: dict = {}


def tile_scan_coords(sx: int, sy: int, w: int, h: int):
    """All bitmap bit positions in stream order.

    Returns (tx, ty, valid): int32 arrays of tile-grid coordinates (units of
    the tile size) per bit, and a bool mask of bits whose tile origin lies
    inside the image. Length = bitmap_size_bytes * 8. Memoized (deterministic
    in its arguments; callers must not mutate the returned arrays).
    """
    key = (sx, sy, w, h)
    hit = _SCAN_COORD_CACHE.get(key)
    if hit is not None:
        return hit
    bx, by, bits = swizzle_spec(sx, sy)
    tw, th = 1 << sx, 1 << sy
    nbx = (w + bx - 1) // bx
    nby = (h + by - 1) // by
    cols = bx >> sx
    rows = by >> sy

    # stream order: big tiles row-major, then tile rows, then tile cols
    big = np.arange(nbx * nby)
    bgy, bgx = big // nbx, big % nbx
    r = np.arange(rows)
    c = np.arange(cols)
    # [big, row, col]
    tx = (bgx[:, None, None] * cols + c[None, None, :]).astype(np.int32)
    ty = (bgy[:, None, None] * rows + r[None, :, None]).astype(np.int32)
    tx = np.broadcast_to(tx, (nbx * nby, rows, cols)).reshape(-1)
    ty = np.broadcast_to(ty, (nbx * nby, rows, cols)).reshape(-1)
    valid = (tx * tw < w) & (ty * th < h)
    for a in (tx, ty, valid):
        a.setflags(write=False)
    _SCAN_COORD_CACHE[key] = (tx, ty, valid)
    return tx, ty, valid


def unpack_bitmap(bitmap: bytes | np.ndarray, sx: int, sy: int, w: int, h: int):
    """Bitmap bytes -> bool array of accept flags in stream order."""
    arr = (bitmap.astype(np.uint8, copy=False) if isinstance(bitmap, np.ndarray)
           else np.frombuffer(bytes(bitmap), np.uint8))
    expect = bitmap_size_bytes(sx, sy, w, h)
    if arr.size != expect:
        raise ValueError(f"bitmap size {arr.size} != expected {expect}")
    return np.unpackbits(arr, bitorder="little").astype(bool)


def pack_bitmap(accept_stream_order: np.ndarray) -> bytes:
    """Inverse of unpack_bitmap (accept flags in stream order -> bytes)."""
    return np.packbits(accept_stream_order.astype(np.uint8),
                       bitorder="little").tobytes()


def accept_grid(bitmap, sx: int, sy: int, w: int, h: int):
    """Bitmap bytes -> (grid, order) where grid is a bool [nty, ntx] accept
    map over the tile grid and order[nty, ntx] is each tile's stream-order
    rank among accepted tiles (-1 if not accepted)."""
    tw, th = 1 << sx, 1 << sy
    ntx = (w + tw - 1) // tw
    nty = (h + th - 1) // th
    bits = unpack_bitmap(bitmap, sx, sy, w, h)
    tx, ty, valid = tile_scan_coords(sx, sy, w, h)
    on = bits & valid
    grid = np.zeros((nty, ntx), bool)
    order = np.full((nty, ntx), -1, np.int64)
    sel = np.flatnonzero(on)
    grid[ty[sel], tx[sel]] = True
    order[ty[sel], tx[sel]] = np.arange(sel.size)
    return grid, order


# ---------------------------------------------------------------------------
# Claim map (tile4x4Mask)
# ---------------------------------------------------------------------------

def claim_shape(w: int, h: int):
    """Quad-grid shape covering the padded claim-byte layout:
    (ceil(h/8)*2, ceil(w/16)*4) quads of 4x4 px."""
    return (((h + 7) // 8) * 2, ((w + 15) // 16) * 4)

