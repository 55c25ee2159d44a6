"""The alpha chunks, MIPM and ALPM, in plain numpy: a frozen copy of the
JAX package's host code, which the port's `encoder/alpha.py` and the host
half of its `decoder/alpha.py` copy in turn.

- Decode (`decode_mipm`, `_unpack6`, `decode_alpm`): `yaik_tpu/decoder/
  alpha.py`, itself a port of the reference decoder's YAIK_Mipmap.cpp
  :23-148 and YAIK_Alpha.cpp :25-377. The result is a full [H, W] u8
  alpha channel, zero outside the chunk's bbox, and a [H, W] bool mipmap
  mask (True where the RGB is meaningful), which the sparse 6-bit modes
  read: MIPM comes before ALPM.
- Encode (`mip_prefilter`, `_pack6`, `process_alpha`, `_zstd_sweep`):
  `yaik_tpu/encoder/alpha.py`, a port of EncoderContext.cpp MipPrefilter
  :1257-1427 (with quadRecursion :357-430) and ProcessAlpha :1429-1682
  (with make1BitStream :317-355). MIPM is one bit per 16x16 tile, not
  compressed, written only where the tiles that are not wholly transparent
  span less than the image. ALPM's payload is compressed at every zstd
  level from 5 to 21 and the smallest kept (the first on a tie), so the
  level it lands on is the libzstd's; the canonical form compares the
  payload decompressed. An alpha that is all 0 or all 255 writes no ALPM,
  and the decoder then gives 255.

The reference decoder's 1-bit row loop (Decompress1BitMaskAlign8NoMask,
YAIK_Alpha.cpp:86) expands one 8-pixel block too few a row and drifts; the
JAX package, the port and this copy expand every block.
"""
from __future__ import annotations

import numpy as np

from portbench.reference import zstd
from portbench.reference.context import _chunk
from portbench.reference.headers import AlphaHeader, MipmapHeader


def decode_mipm(body: bytes, w: int, h: int) -> np.ndarray:
    """A MIPM chunk's body -> [H, W] bool mask, True where RGB is
    meaningful."""
    hdr = MipmapHeader.unpack(body)
    ts = 1 << hdr.mipmap_level
    if ts != 16:
        raise ValueError("MIPM: only 16-pixel tiles decode "
                         "(YAIK_Mipmap.cpp:53)")
    ntiles = hdr.w * hdr.h
    bits = np.unpackbits(np.frombuffer(body[MipmapHeader.size():], np.uint8,
                                       (ntiles + 7) // 8),
                         bitorder="little")[:ntiles].astype(bool)
    sub = np.repeat(np.repeat(bits.reshape(hdr.h, hdr.w), ts, axis=0),
                    ts, axis=1)
    mask = np.zeros((h, w), bool)
    y0, x0 = hdr.y * ts, hdr.x * ts
    # the encoder's tile grid is ceil(w / 16) wide, so the expansion can
    # overhang an image side that is not a multiple of 16
    sh = min(sub.shape[0], h - y0)
    sw = min(sub.shape[1], w - x0)
    if sh <= 0 or sw <= 0:
        raise ValueError("MIPM bbox outside image")
    mask[y0:y0 + sh, x0:x0 + sw] = sub[:sh, :sw]
    return mask


def _unpack6(raw: np.ndarray, count: int, inverse: bool) -> np.ndarray:
    """`count` 6-bit values (4 in 3 bytes) -> 8-bit (v << 2 | v >> 4)."""
    need = (count * 6 + 7) // 8
    buf = np.zeros(((need + 2) // 3) * 3, np.uint8)
    buf[:len(raw[:need])] = raw[:need]
    b = buf.reshape(-1, 3).astype(np.uint32)
    v0 = b[:, 0] & 0x3F
    v1 = (b[:, 0] >> 6) | ((b[:, 1] & 0xF) << 2)
    v2 = (b[:, 1] >> 4) | ((b[:, 2] & 0x3) << 4)
    v3 = b[:, 2] >> 2
    v = np.stack([v0, v1, v2, v3], axis=1).reshape(-1)[:count]
    if inverse:
        v = 63 - v
    return ((v << 2) | (v >> 4)).astype(np.uint8)


def decode_alpm(body: bytes, w: int, h: int,
                mip_mask: np.ndarray | None) -> np.ndarray:
    """An ALPM chunk's body -> [H, W] u8 alpha channel."""
    hdr = AlphaHeader.unpack(body)
    n = AlphaHeader.size()
    raw = np.frombuffer(zstd.decompress(body[n:n + hdr.stream_size],
                                        hdr.expected_decompression_size),
                        np.uint8)
    mode = hdr.parameters & 7
    bx, by, bw, bh = hdr.x, hdr.y, hdr.w, hdr.h
    alpha = np.zeros((h, w), np.uint8)
    if mode == AlphaHeader.IS_1_BIT_FULL:
        bits = np.unpackbits(raw, bitorder="little")[:bw * bh]
        alpha[by:by + bh, bx:bx + bw] = bits.reshape(bh, bw) * 255
    elif mode in (AlphaHeader.IS_6_BIT_FULL,
                  AlphaHeader.IS_6_BIT_FULL_INVERSE):
        inv = mode == AlphaHeader.IS_6_BIT_FULL_INVERSE
        alpha[by:by + bh, bx:bx + bw] = _unpack6(raw, bw * bh,
                                                 inv).reshape(bh, bw)
    elif mode in (AlphaHeader.IS_6_BIT_USEMIPMAPMASK,
                  AlphaHeader.IS_6_BIT_USEMIPMAPMASK_INVERSE):
        if mip_mask is None:
            raise ValueError("sparse alpha requires a MIPM chunk first")
        inv = mode == AlphaHeader.IS_6_BIT_USEMIPMAPMASK_INVERSE
        sel = mip_mask[by:by + bh, bx:bx + bw]
        region = np.zeros((bh, bw), np.uint8)
        region[sel] = _unpack6(raw, int(sel.sum()), inv)
        alpha[by:by + bh, bx:bx + bw] = region
    elif mode == AlphaHeader.IS_8_BIT_FULL:
        alpha[by:by + bh, bx:bx + bw] = raw[:bw * bh].reshape(bh, bw)
    else:
        raise ValueError(f"unsupported alpha mode {mode}")
    return alpha


def _zstd_sweep(data: bytes) -> bytes:
    """Levels 5..21, the smallest result (the first on a tie); the sweep
    stops once a level's result outgrows the best (EncoderContext.cpp
    :1590-1615)."""
    best, best_lvl = None, 5
    for lvl in range(5, 22):
        z = zstd.compress(data, lvl, len(data) * 2)
        if best is None or len(z) < best:
            best, best_lvl = len(z), lvl
        elif len(z) > best:
            break
    return zstd.compress(data, best_lvl, len(data) * 2)


def mip_prefilter(alpha: np.ndarray, tile_shift: int = 4) -> tuple:
    """Alpha-zero tile rejection: (mask [H, W] bool, True where the RGB is
    meaningful; the MIPM chunk or None; the kept tiles' bbox in pixels,
    (x0, y0, x1, y1))."""
    h, w = alpha.shape
    ts = 1 << tile_shift
    nty, ntx = (h + ts - 1) // ts, (w + ts - 1) // ts
    a = np.zeros((nty * ts, ntx * ts), alpha.dtype)
    a[:h, :w] = alpha
    keep = a.reshape(nty, ts, ntx, ts).max(axis=(1, 3)) != 0
    mip_mask = np.repeat(np.repeat(keep, ts, axis=0), ts, axis=1)[:h, :w]
    if keep.all():
        return np.ones((h, w), bool), None, (0, 0, w, h)
    ty, tx = np.nonzero(keep)
    if ty.size == 0:
        # wholly transparent: the full mask, and no chunk
        return np.ones((h, w), bool), None, (0, 0, w, h)
    tx0, tx1 = int(tx.min()), int(tx.max()) + 1
    ty0, ty1 = int(ty.min()), int(ty.max()) + 1
    if (tx0, ty0, tx1 * ts, ty1 * ts) == (0, 0, w, h):
        return mip_mask, None, (0, 0, w, h)
    bits = np.packbits(keep[ty0:ty1, tx0:tx1].reshape(-1).astype(np.uint8),
                       bitorder="little")
    hdr = MipmapHeader(x=tx0, y=ty0, w=tx1 - tx0, h=ty1 - ty0,
                       stream_size=len(bits), version=1,
                       mipmap_level=tile_shift)
    return (mip_mask, _chunk(b"MIPM", hdr.pack() + bits.tobytes()),
            (tx0 * ts, ty0 * ts, tx1 * ts, ty1 * ts))


def _pack6(vals: np.ndarray) -> bytes:
    """6-bit values, 4 in 3 bytes (little-endian bit order), the bytes
    that carry no bit dropped."""
    n = len(vals)
    v = np.concatenate([vals, np.zeros((-n) % 4, vals.dtype)]
                       ).reshape(-1, 4).astype(np.uint32)
    b0 = (v[:, 0] | (v[:, 1] << 6)) & 0xFF
    b1 = ((v[:, 1] >> 2) | (v[:, 2] << 4)) & 0xFF
    b2 = ((v[:, 2] >> 4) | (v[:, 3] << 2)) & 0xFF
    packed = np.stack([b0, b1, b2], axis=1).astype(np.uint8).reshape(-1)
    return packed.tobytes()[:(n * 6 + 7) // 8]


def process_alpha(alpha: np.ndarray, mip_mask: np.ndarray | None,
                  mip_bound: tuple, force_8bit: bool = True,
                  use_inverse: bool = True) -> bytes | None:
    """ProcessAlpha: the ALPM chunk of an [H, W] u8 alpha, or None."""
    bx0, by0, bx1, by1 = mip_bound
    a = alpha.astype(np.int32)
    nz = np.argwhere((a[by0:by1, bx0:bx1] >> 2) != 0)
    if nz.size == 0:
        return None                    # zero in 6 bits: no chunk
    (ry0, rx0), (ry1, rx1) = nz.min(axis=0), nz.max(axis=0)
    bl, bt = int(rx0) + bx0, int(ry0) + by0
    br, bb = int(rx1) + bx0 + 1, int(ry1) + by0 + 1
    bl = (bl >> 2) << 2
    br = ((br + 3) >> 2) << 2
    # the mode is chosen on the aligned bbox alone (:1510-1560)
    vals8 = a[bt:bb, bl:br]
    if bool((vals8 == 0).all()) or bool((vals8 == 255).all()):
        return None
    if not bool(((vals8 != 255) & (vals8 != 0)).any()):
        # binary alpha: one bit a pixel over an 8-aligned bbox
        bl8, br8 = (bl >> 3) << 3, ((br + 7) >> 3) << 3
        raw = np.packbits((a[bt:bb, bl8:br8] & 1).astype(np.uint8)
                          .reshape(-1), bitorder="little").tobytes()
        params = AlphaHeader.IS_1_BIT_FULL
        bbox = (bl8, bt, br8 - bl8, bb - bt)
    elif force_8bit:
        raw = vals8.astype(np.uint8).tobytes()
        params = AlphaHeader.IS_8_BIT_FULL
        bbox = (bl, bt, br - bl, bb - bt)
    else:
        if mip_mask is not None and not mip_mask.all():
            sel = vals8[mip_mask[bt:bb, bl:br]]
            params = (AlphaHeader.IS_6_BIT_USEMIPMAPMASK_INVERSE
                      if use_inverse else AlphaHeader.IS_6_BIT_USEMIPMAPMASK)
        else:
            sel = vals8.reshape(-1)
            params = (AlphaHeader.IS_6_BIT_FULL_INVERSE if use_inverse
                      else AlphaHeader.IS_6_BIT_FULL)
        v6 = (sel >> 2).astype(np.uint8)
        if use_inverse:
            v6 = (63 - v6).astype(np.uint8)
        raw = _pack6(v6)
        bbox = (bl, bt, br - bl, bb - bt)
    z = _zstd_sweep(raw)
    hdr = AlphaHeader(x=bbox[0], y=bbox[1], w=bbox[2], h=bbox[3],
                      stream_size=len(z), expected_decompression_size=len(raw),
                      version=1, parameters=params)
    return _chunk(b"ALPM", hdr.pack() + z)
