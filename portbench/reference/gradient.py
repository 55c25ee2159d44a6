"""FittingQuadSmooth: the multi-scale gradient-tile pass, host side.

A frozen copy of the port's `encoder/gradient.py` (reference
`EncoderContext.cpp:3710-4363`) without its native emission: the host
scorer (`score_pass`) and the emission (`emit_pass`) of each accepted
tile's Round6-rounded, CompressF-posterized corners, deduplicated through
the mappedRGB corner grid, into the chunk's RGB stream in swizzle scan
order.

Per tile size (pass order 16x16,16x8,8x16,8x8,8x4,4x8,4x4), a tile is
accepted if, under ANY of six corner-rounding variants (888/666/666-exp,
each with/without +rounding bias), every pixel of every plane is within
rejectFactor of the bilinear blend of the 4 corner colors.
"""
from __future__ import annotations

import numpy as np

from portbench.reference import swizzle

WEIGHTS = {
    4: np.array([1024, 768, 512, 256], np.int64),
    8: np.array([1024, 896, 768, 640, 512, 384, 256, 128], np.int64),
    16: np.array([1024, 960, 896, 832, 768, 704, 640, 576, 512, 448, 384,
                  320, 256, 192, 128, 64], np.int64),
}

ROUNDING = (1 << 19) - 1


def round6(v):
    r = v >> 2
    return (r << 2) | (r >> 4)


def round6p(v):
    v = np.minimum(v + 1, 255)
    r = v >> 2
    return (r << 2) | (r >> 4)


def compress_f(v, rate):
    return ((v * rate) + 127) // 255


def _corner_grids(planes: np.ndarray, tw: int, th: int):
    """Corner colors for every tile position, with edge-clamped reads
    (Plane::GetPixelValue clamps x>=w to w-1). planes: [3,H,W] int.
    Returns [3, nty+1, ntx+1] sample grid at tile-corner positions."""
    _, h, w = planes.shape
    xs = np.minimum(np.arange(0, w + tw, tw), w - 1)
    ys = np.minimum(np.arange(0, h + th, th), h - 1)
    return planes[:, ys[:, None], xs[None, :]]


def score_pass(planes: np.ndarray, claims: np.ndarray, sx: int, sy: int,
               reject_factor: int, plane_mask: int = 7):
    """Vectorized accept test for all tile positions of one size.

    planes: [3,H,W] int32 source; claims: [3,H,W] bool (mapSmoothTile).
    plane_mask: present-plane bits (FittingQuadSmooth's NULL-plane calls,
    the disabled 2-plane/1-plane 4x4 passes at EncoderContext.cpp:
    9260-9290/9392-9420): missing planes read as 0 on BOTH sides of the
    reject test (blend of zero corners vs zero pixels -> error 0), and the
    allow gate checks only present planes' claims.
    Returns accept [nty, ntx] bool (full-tile positions only).
    """
    tw, th = 1 << sx, 1 << sy
    _, h, w = planes.shape
    ntx, nty = w // tw, h // th
    if plane_mask != 7:
        planes = planes.copy()
        for p in range(3):
            if not (plane_mask & (1 << p)):
                planes[p] = 0
    corners = _corner_grids(planes, tw, th).astype(np.int64)  # [3,nty+1,ntx+1]

    c00 = corners[:, :nty, :ntx]
    c01 = corners[:, :nty, 1:]
    c10 = corners[:, 1:, :ntx]
    c11 = corners[:, 1:, 1:]

    # pixel view [3, nty, th, ntx, tw]
    pix = planes[:, :nty * th, :ntx * tw].reshape(3, nty, th, ntx, tw)
    pix = pix.transpose(0, 1, 3, 2, 4).astype(np.int64)  # [3,nty,ntx,th,tw]

    lf = WEIGHTS[tw][None, None, None, None, :]          # dx weights
    rf = 1024 - lf
    tf = WEIGHTS[th][None, None, None, :, None]          # dy weights
    bf = 1024 - tf

    def blends(a, b, c, d):
        """Return (with-rounding, without-rounding) blend per pixel."""
        top = a[:, :, :, None, None] * lf + b[:, :, :, None, None] * rf
        bot = c[:, :, :, None, None] * lf + d[:, :, :, None, None] * rf
        num = top * tf + bot * bf
        return (num + ROUNDING) // (1024 * 1024), num // (1024 * 1024)

    variants = []
    variants.extend(blends(c00, c01, c10, c11))                    # 888
    variants.extend(blends(round6(c00), round6(c01),
                           round6(c10), round6(c11)))              # 666
    variants.extend(blends(round6p(c00), round6p(c01),
                           round6p(c10), round6p(c11)))            # 666-exp

    ok = np.zeros((nty, ntx), bool)
    for bl in variants:
        err = np.abs(pix - bl)
        ok |= (err <= reject_factor).all(axis=(0, 3, 4))

    # allow-check: mapSmoothTile at the tile ORIGIN only, present planes
    origins = claims[:, ::th, ::tw][:, :nty, :ntx]
    present = [p for p in range(3) if plane_mask & (1 << p)]
    allow = ~origins[present].any(axis=0)
    return ok & allow


def run_pass(planes, claims, mapped_rgb, sx, sy, reject_factor,
             color_compression, plane_mask: int = 7):
    """Run one gradient pass (host scoring). Mutates claims ([3,H,W] bool)
    and mapped_rgb. Returns (bitmap_bytes, rgb_stream_bytes, tile_count)."""
    accept = score_pass(planes, claims, sx, sy, reject_factor, plane_mask)
    return emit_pass(planes, claims, mapped_rgb, accept, sx, sy,
                     color_compression, plane_mask)


def emit_pass(planes, claims, mapped_rgb, accept, sx, sy, color_compression,
              plane_mask: int = 7, corners4=None, claims4=None):
    """Stream emission for one gradient pass given its accept grid (from
    host or device scoring): swizzle-scan-order corner dedup + claim update.

    corners4: optional shared [3, h/4+1, w/4+1] i64 corner grid (every
    pass's corner positions are a stride-of-4 subset, so one gather serves
    all 7 passes instead of recomputing per pass). claims4: optional
    [h/4, w/4] bool accumulator - when given, the per-pixel claim update
    is DEFERRED (caller ORs the 4x4-block accepts and expands once; the
    7 per-pass full-image repeats were ~2 ms/image)."""
    tw, th = 1 << sx, 1 << sy
    _, h, w = planes.shape

    tx_all, ty_all, valid = swizzle.tile_scan_coords(sx, sy, w, h)
    # full-tile-inside check (reference breaks when x+tileSize > imgW)
    inside = ((tx_all + 1) * tw <= w) & ((ty_all + 1) * th <= h)
    bits = np.zeros(tx_all.shape[0], bool)
    sel_mask = valid & inside
    bits[sel_mask] = accept[ty_all[sel_mask], tx_all[sel_mask]]

    order = np.flatnonzero(bits)
    if len(order) == 0:
        return None, None, 0

    # vectorized corner dedup: first touch in tile-scan x (LT, RT, LB, RB)
    # order == the reference's per-tile "emit corner if unseen" cursor.
    # Emission interleaves planes within a corner (srcA, srcB, srcC order,
    # EncoderContext.cpp:4115-4133), deduped per plane's mappedRGB grid.
    txs, tys = tx_all[order], ty_all[order]
    xs, ys = txs.astype(np.int64) * tw, tys.astype(np.int64) * th
    w1 = w + 1
    cids = np.stack([ys * w1 + xs, ys * w1 + xs + tw,
                     (ys + th) * w1 + xs, (ys + th) * w1 + xs + tw],
                    axis=1).reshape(-1)
    _, first = np.unique(cids, return_index=True)
    isfirst = np.zeros(cids.size, bool)
    isfirst[first] = True
    present = [p for p in range(3) if plane_mask & (1 << p)]
    cy, cx = cids // w1, cids % w1
    # round6 only the gathered corners (not the full grid - emit_pass runs
    # 7x per image and accepted tiles are a small subset). Corner pixel
    # coords are multiples of (th, tw) so cy//4, cx//4 index the shared
    # 4x4 grid directly (same edge clamp).
    if corners4 is None:
        corners4 = _corner_grids(planes, 4, 4).astype(np.int64)
    vals6 = round6(corners4[:, cy // 4, cx // 4])    # [3, n*4]
    newp = np.zeros((len(present), cids.size), bool)
    for j, p in enumerate(present):
        mp = mapped_rgb[p].reshape(-1)
        newp[j] = isfirst & ~mp[cids]
        mp[cids[newp[j]]] = True
    # byte sequence: corner-major, plane-minor
    sel = newp.T.reshape(-1)                          # [n*4, P] flattened
    byte_vals = compress_f(vals6[present].T.reshape(-1), color_compression)
    rgb_stream = byte_vals[sel].astype(np.uint8).tobytes()

    up = np.zeros((h // th, w // tw), bool)
    up[tys, txs] = True
    if claims4 is not None and len(present) == 3:
        claims4[: (h // th) * (th // 4), : (w // tw) * (tw // 4)] |= \
            np.repeat(np.repeat(up, th // 4, 0), tw // 4, 1)
    else:
        claim_tiles(claims, up, th, tw, present)

    bitmap = swizzle.pack_bitmap(bits)
    return bitmap, rgb_stream, len(order)


def claim_tiles(claims, up, th, tw, present):
    """OR a [nty, ntx] accept grid into per-pixel claims (runs 13x per
    image). Contiguous repeat + basic-slice OR beats a strided broadcast
    into the reshaped view by ~2x here; skip entirely when nothing accepts."""
    if not up.any():
        return
    rep = np.repeat(np.repeat(up, th, 0), tw, 1)
    if len(present) == 3:
        claims[:, :rep.shape[0], :rep.shape[1]] |= rep[None]
    else:
        claims[list(present), :rep.shape[0], :rep.shape[1]] |= rep[None]
