"""Host emission of the 3D LUT streams from device scoring results.

Numpy copies of `yaik_tpu.encoder.device_pipeline.emit_tile3d_streams` and
`emit_tile3d_streams_compact` (with `_scan_perm`), whose module imports
jax: accepted tiles in swizzle-scan order append their bbox, type and
unmasked window indices to the streams, exactly as the host pass
`corr3d.run_pass` does. The compact form reads the accepted tiles' packed
rows, which the device gathered in scan order already.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from yaik_tpu_torch.format import swizzle


def slot_order(tw: int, th: int) -> np.ndarray:
    """Pixel order of a tile's index stream: 8-column blocks, then rows,
    then columns (computeValues3D, EncoderContext.cpp:5854-5860)."""
    if tw <= 8:
        return np.arange(th * tw)
    return np.asarray([y * tw + xa * 8 + x for xa in range(2)
                       for y in range(th) for x in range(8)])


def emit_tile3d_streams(results: list[dict], w: int, h: int,
                        streams: dict) -> None:
    """Append every pass's accepted tiles to `streams` (the dict of
    `context.encode_image`: color, type, 3..6 and maps)."""
    for res in results:
        sx, sy = res["shift"]
        tw, th = 1 << sx, 1 << sy
        tx_all, ty_all, valid = swizzle.tile_scan_coords(sx, sy, w, h)
        inside = ((tx_all + 1) * tw <= w) & ((ty_all + 1) * th <= h)
        bits = np.zeros(tx_all.shape[0], bool)
        sel = np.flatnonzero(valid & inside)
        gids = ty_all[sel].astype(np.int64) * (w // tw) + tx_all[sel]
        acc = res["accept"][gids].astype(bool)
        sel, gids = sel[acc], gids[acc]
        if gids.size:
            bits[sel] = True
            streams["color"] += res["bbox"][gids].astype(np.uint8).tobytes()
            tvals = res["type"][gids].astype(np.int64)
            streams["type"].extend(tvals.tolist())
            order = slot_order(tw, th)
            idxo = res["idx"][gids][:, order]
            masko = res["mask"][gids][:, order].astype(bool)
            bit_arr = ((tvals >> 14) & 3) + 3
            for bit in (3, 4, 5, 6):
                tb = bit_arr == bit
                if tb.any():
                    streams[bit] += idxo[tb][~masko[tb]].astype(
                        np.uint8).tobytes()
        packed = np.frombuffer(swizzle.pack_bitmap(bits), np.uint8)
        m = streams["maps"][(sx, sy)]
        m[:len(packed)] |= packed


@lru_cache(maxsize=None)
def _scan_perm(sx: int, sy: int, w: int, h: int):
    """(sel0 slot ids, gids tile ids) of the pass's whole tiles in
    swizzle-scan order (cached per shape; callers must not write them)."""
    tw, th = 1 << sx, 1 << sy
    tx, ty, valid = swizzle.tile_scan_coords(sx, sy, w, h)
    inside = ((tx + 1) * tw <= w) & ((ty + 1) * th <= h)
    sel0 = np.flatnonzero(valid & inside)
    gids = (ty[sel0].astype(np.int64) * (w // tw) + tx[sel0]).astype(
        np.int32)
    return sel0, gids


def emit_tile3d_streams_compact(per_pass: list[dict], w: int, h: int,
                                streams: dict) -> None:
    """`emit_tile3d_streams` from one image's compacted results: per pass
    a dict of shift, bits_scan [Ts] bool (accepts in scan order), count
    and rows [>= count, P+9] u8 (the accepted tiles' packed rows in scan
    order: idx | mask << 6, accept, type lo, type hi, bbox)."""
    for res in per_pass:
        sx, sy = res["shift"]
        tw, th = 1 << sx, 1 << sy
        P = tw * th
        sel0, _ = _scan_perm(sx, sy, w, h)
        tx_all, _, _ = swizzle.tile_scan_coords(sx, sy, w, h)
        bits = np.zeros(tx_all.shape[0], bool)
        bits[sel0] = res["bits_scan"]
        C = int(res["count"])
        if C:
            rows = res["rows"][:C]
            streams["color"] += rows[:, P + 3:P + 9].tobytes()
            tvals = (rows[:, P + 1].astype(np.int64)
                     | (rows[:, P + 2].astype(np.int64) << 8))
            streams["type"].extend(tvals.tolist())
            im = rows[:, :P][:, slot_order(tw, th)]
            idxo = im & 63
            masko = (im >> 6).astype(bool)
            bit_arr = ((tvals >> 14) & 3) + 3
            for bit in (3, 4, 5, 6):
                tb = bit_arr == bit
                if tb.any():
                    streams[bit] += idxo[tb][~masko[tb]].astype(
                        np.uint8).tobytes()
        packed = np.frombuffer(swizzle.pack_bitmap(bits), np.uint8)
        m = streams["maps"][(sx, sy)]
        m[:len(packed)] |= packed
