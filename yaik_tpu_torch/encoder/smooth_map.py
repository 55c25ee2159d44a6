"""SmoothMap: gradient-region map + 1/16-res YCoCg seed points -> SMAP chunk.

The port's copy of `yaik_tpu/encoder/smooth_map.py`.

Re-expresses the reference's DEAD pass (EncoderContext.cpp:2564-2764 - no
call site in Convert; the decoder deprecates the tag at YAIK_API.cpp:569)
with its *defined* semantics. The reference pass cannot run as written: its
RGB-seed loop indexes the half-res smooth map with full-res coordinates -
reads are edge-clamped (framework.h:116-121) but the 128-marker writes at
:2686 and the final RemoveMask at :2728 go past the quarter buffer, and
glibc aborts on the heap corruption (reproduce with
tools/refbuild/ref_encoder_smap on any fixture image). Deviations here,
each the defined prefix of the corresponding reference loop:

- the 128-marker is only written when (x, y) lands inside the half-res map;
- the final mipmapMask removal stops at the half-res buffer's extent
  (linear index < qw*qh), exactly where the reference's reads become UB.

Everything else follows the reference line by line: the |ddx|,|ddy|<4
gradient maps (computeGradientMap :472), the EQUAL-of-EQUAL plane combine
(:2577-2578 - a binary-mask equality, NOT a 3-way AND: two "rough" planes
and one "smooth" plane also compare equal), the erosion + half-res
reduction, the 8-aligned bbox, make1BitStream packing (:317), and the two
zstd sweeps (21 down to 11; the map stream is recompressed at the winning
level :2645 while the RGB stream keeps the LAST tested level's buffer
:2704-2724 - a reference quirk)."""
from __future__ import annotations

import numpy as np

from yaik_tpu_torch.entropy import zstd_backend as zstd
from yaik_tpu_torch.format.headers import HeaderBase, HeaderSmoothMap
from yaik_tpu_torch.ops import plane as ops


def _gradient_map(p: np.ndarray) -> np.ndarray:
    """computeGradientMap (:472): 255 where max(|ddx|,|ddy|) < 4."""
    ddx = ops.apply_diff(p, 1, "left_right")
    ddy = ops.apply_diff(p, 1, "top_down")
    return np.where(np.maximum(np.abs(ddx), np.abs(ddy)) < 4, 255, 0)


def _zstd_sweep_21_11(data: bytes, recompress_best: bool):
    """The SMAP sweep (:2624-2645): levels 21 down to 11, tracking the best;
    break as soon as a level is strictly worse than the best. The map stream
    is then recompressed at the best level; the RGB stream keeps the buffer
    of the level where the loop stopped (reference quirk)."""
    best = 99999999
    best_lvl = 21
    last = b""
    for lvl in range(21, 10, -1):
        z = zstd.compress(data, lvl, len(data) * 2)
        last = z
        if best > len(z):
            best = len(z)
            best_lvl = lvl
        elif len(z) > best:
            break
    if recompress_best:
        return zstd.compress(data, best_lvl, len(data) * 2)
    return last


def _make_1bit(plane: np.ndarray, bbox) -> bytes:
    """make1BitStream (:317): row-major LSB-first pack of value&1 over the
    bbox (no skip plane here). Flat addressing like the reference's
    idx = x + y*w, so an 8-aligned bbox that sticks out past the plane edge
    wraps into the next row (in-buffer reads stay defined; reads past the
    buffer yield 0 where the reference is UB)."""
    x0, y0, bw, bh = bbox
    h, w = plane.shape
    flat = plane.reshape(-1)
    ys, xs = np.mgrid[y0:y0 + bh, x0:x0 + bw]
    idx = (xs + ys * w).reshape(-1)
    vals = np.where(idx < flat.size, flat[np.minimum(idx, flat.size - 1)], 0)
    return np.packbits((vals & 1).astype(np.uint8),
                       bitorder="little").tobytes()


def smooth_map(planes: np.ndarray, mip_mask: np.ndarray | None):
    """Run the pass over planes [3, H, W] i32 RGB.

    Returns (SMAP chunk bytes, updated mip_mask [H, W] bool, seeds) where
    seeds is the [n, 5] (x, y, Y, Co, Cg) list the chunk's RGB stream
    carries (decode support + tests)."""
    _, h, w = planes.shape
    if mip_mask is None:
        mip_mask = np.ones((h, w), bool)
    mip = mip_mask.copy()

    yy, co, cg = ops.rgb_to_ycocg(planes[0], planes[1], planes[2])
    grad_r = _gradient_map(yy)
    grad_g = _gradient_map(co)
    grad_b = _gradient_map(cg)
    grad_rg = np.where(grad_r == grad_g, 255, 0)
    grad_rgb = np.where(grad_rg == grad_b, 255, 0)
    smooth = grad_rgb & np.where(mip, 255, 0)          # AND_OP

    ops.erosion(smooth)
    q = ops.reduce_quarter_logic_max(smooth)           # half-res per axis
    qh, qw = q.shape

    bx, by, bww, bhh = ops.bbox_nonzero(q)
    if bww == 0:
        x0 = y0 = bw = bh = 0
        surface = 0
    else:
        end_x, end_y = bx + bww, by + bhh     # exclusive ends (:2602-2603)
        x0 = (bx >> 3) << 3                   # align to 8 (:2605-2609)
        y0 = (by >> 3) << 3
        bw = (((end_x + 7) >> 3) << 3) - x0
        bh = (((end_y + 7) >> 3) << 3) - y0
        surface = bw * bh

    seeds = []
    if surface:
        raw_map = _make_1bit(q, (x0, y0, bw, bh))
        z_map = _zstd_sweep_21_11(raw_map, recompress_best=True)

        # RGB seed loop (:2666-2697): full-res (x, y) stepping 4, CLAMPED
        # half-res map reads; marker writes only inside the map (see above)
        rgb_stream = bytearray()
        for y in range(0, h, 4):
            for x in range(0, w, 4):
                cx, cy = min(x, qw - 1), min(y, qh - 1)
                if q[cy, cx]:
                    mip[y, x] = False
                    # raw idx = x + y*qw: in-buffer writes stay defined even
                    # when x >= qw (wraps into the next row); beyond = UB
                    # upstream, skipped here
                    if x + y * qw < qw * qh:
                        q.reshape(-1)[x + y * qw] = 128
                    vy = int(yy[y, x]) & 0xFF
                    vo = int(co[y, x]) & 0xFF
                    vg = int(cg[y, x]) & 0xFF
                    rgb_stream += bytes((vy, vo, vg))
                    seeds.append((x, y, vy, vo, vg))
        z_rgb = _zstd_sweep_21_11(bytes(rgb_stream), recompress_best=False)
    else:
        raw_map = b""
        rgb_stream = b""
        z_map = b""
        z_rgb = b""

    # defined prefix of mipmapMask->RemoveMask(half-res clone) (:2728)
    flat_mask = mip.reshape(-1)
    flat_q = q.reshape(-1)
    n = min(flat_mask.size, flat_q.size)
    flat_mask[:n] &= flat_q[:n] == 0

    hdr = HeaderSmoothMap(
        x=x0, y=y0, w=bw, h=bh,
        stream_size=len(z_map), rgb_stream_size=len(z_rgb),
        expected_rgb_stream_size=len(rgb_stream),
        version=1, grid=0)
    body = hdr.pack() + z_map + z_rgb
    length = (len(body) + 3) & ~3
    chunk = (HeaderBase(b"SMAP", length).pack() + body
             + b"\0" * (length - len(body)))
    return chunk, mip, np.asarray(seeds, np.int32).reshape(-1, 5)
