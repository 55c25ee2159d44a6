"""Correlation2DSearch: the 2-plane 2D-LUT tile pass (RG / GB / RB).

The port's copy of `yaik_tpu/encoder/corr2d.py`.

Mirrors the reference's disabled pass: Correlation2DSearch
(EncoderContext.cpp:6781-7310), buildBBox2D (:202), computeValues2D
(:5548-5805), EvalCtx2D::EvaluatePoint2D / GetEvaluation2D
(EncoderContext.h:533-590). Only 8x8 and 4x4 tiles exist in this path
(Convert's #if 0 block :9323-9382 calls sizes (3,3) and (2,2) per mode).

Scoring normalization is the fixed-point variant (va * ((1<<20)/d), then
f32 /2^20 *63, truncate, :6877-6945); computeValues2D uses direct f32
division - they can disagree by one index, both replicated exactly.
"""
from __future__ import annotations

import numpy as np

from yaik_tpu_torch.format import swizzle

FACTOR = 128
SKIP = 4  # SKIP_TOO_LOSSY

# PlaneMode -> (plane A, plane B) indices (EncoderContext.h:293-297)
PAIR = {0: (0, 1), 1: (1, 2), 2: (0, 2)}    # Mode_RG, Mode_GB, Mode_RB
COMPONENT = {0: 3, 1: 6, 2: 5}              # R|G, G|B, R|B bitmasks


def score_patterns(ia, ib, dist_field):
    """sumDistance2D for the 8 transforms (EvaluatePoint2D,
    EncoderContext.h:544-560): bit0 flip X, bit1 flip Y, bit2 swap X/Y -
    with the flips applied to the POST-swap coordinates (case 5 is
    (63-y, x<<6)). Note this is the OPPOSITE composition order from
    computeValues2D (:5630-5638, flip-then-swap), so patterns 5 and 6 score
    one transform but reconstruct another - a reference inconsistency that
    affects which pattern wins per LUT. dist_field indexed [y, x]."""
    sums = np.empty(8, np.int64)
    for n in range(8):
        cx, cy = (ib, ia) if (n & 4) else (ia, ib)
        if n & 1:
            cx = 63 - cx
        if n & 2:
            cy = 63 - cy
        sums[n] = dist_field[cy, cx].sum()
    return sums


def get_evaluation(sums):
    """GetEvaluation2D: argmin with strict < against a float threshold ->
    first minimum wins (raw int sums, no /1024 averaging unlike 3D)."""
    best = np.float32(999999999.0)
    res = -1
    for f in range(8):
        if sums[f] < best:
            best = np.float32(sums[f])
            res = f
    return res


def compute_values(tile_ab, mask, mode, bb, ctx):
    """computeValues2D. tile_ab: i64 [th, tw, 2] pair-channel values; mask:
    bool [th, tw] True = claimed; bb: (minA, minB, maxA, maxB).
    Returns (m 0..3 or SKIP, diff_sum, values dict bit -> u8 indices)."""
    minA, minB, maxA, maxB = bb
    dx, dy = maxA - minA, maxB - minB
    ys, xs = np.nonzero(~mask)            # row-major = stream order (<=8 wide)
    if ys.size == 0:
        return SKIP, 0, {}
    ab = tile_ab[ys, xs]                  # [n, 2]

    rel = (ab - np.array([minA, minB])[None, :]).astype(np.float32)
    if dx:
        rel[:, 0] = rel[:, 0] / np.float32(dx)
    if dy:
        rel[:, 1] = rel[:, 1] / np.float32(dy)
    rel = rel * np.float32(63.0)
    mx = ((np.float32(63.0) - rel[:, 0]) if mode & 1 else rel[:, 0]).astype(np.int64)
    my = ((np.float32(63.0) - rel[:, 1]) if mode & 2 else rel[:, 1]).astype(np.int64)
    if mode & 4:
        mx, my = my, mx

    d2 = np.array([dx, dy], np.int64)
    mn2 = np.array([minA, minB], np.int64)
    values = {}
    diffs = {}
    reject = {}
    for bit in (3, 4, 5, 6):
        # the 3-bit lookup uses the 4-BIT position map (:5641) and overruns
        # the 3-bit factor tables - ctx.factors_ext3 reproduces those reads
        idx = ctx.position[4 if bit == 3 else bit][my, mx]
        values[bit] = idx.astype(np.uint8)
        f = (ctx.factors_ext3 if bit == 3 else ctx.factors[bit])[idx].astype(np.int64)
        fx, fy = f[:, 0], f[:, 1]
        if mode & 1:
            fx = FACTOR - fx
        if mode & 2:
            fy = FACTOR - fy
        if mode & 4:
            fx, fy = fy, fx
        recon = mn2[None, :] + (np.stack([fx, fy], 1) * d2[None, :]) // FACTOR
        ldiff = np.abs(recon - ab).max(axis=1)
        diffs[bit] = int(ldiff.sum())
        reject[bit] = bool((ldiff > 6).any())
    for bit in (3, 4, 5, 6):              # fewest bits first (:5794-5800)
        if not reject[bit]:
            return bit - 3, diffs[bit], values
    return SKIP, diffs[6], values


def run_pass(planes, claims, bank, plane_mode, sx, sy, streams):
    """One Correlation2DSearch size pass. planes: [3,H,W] i32; claims:
    [3,H,W] bool (mapSmoothTile); bank: bank2d.Bank2D; streams: same dict
    shape as corr3d.run_pass."""
    pa, pb = PAIR[plane_mode]
    tw, th = 1 << sx, 1 << sy
    _, h, w = planes.shape
    tx_all, ty_all, valid = swizzle.tile_scan_coords(sx, sy, w, h)
    inside = ((tx_all + 1) * tw <= w) & ((ty_all + 1) * th <= h)

    bitmap_bits = np.zeros(tx_all.shape[0], bool)

    for i in np.flatnonzero(valid & inside):
        tx, ty = int(tx_all[i]), int(ty_all[i])
        x, y = tx * tw, ty * th
        tile = planes[:, y:y + th, x:x + tw].astype(np.int64)
        # buildBBox2D: claimed when EITHER pair plane is claimed (:233)
        mask = claims[pa, y:y + th, x:x + tw] | claims[pb, y:y + th, x:x + tw]
        sel = ~mask
        if not sel.any():
            continue
        a = tile[pa][sel]
        b = tile[pb][sel]
        minA, maxA = int(a.min()), int(a.max())
        minB, maxB = int(b.min()), int(b.max())
        dX, dY = maxA - minA, maxB - minB
        if dX == 0 or dY == 0:            # accept gate (:6863)
            continue

        # fixed-point scoring coords (:6878-6945)
        nx, ny = (1 << 20) // dX, (1 << 20) // dY
        fa = ((a - minA) * nx).astype(np.float32) / np.float32(1 << 20)
        fb = ((b - minB) * ny).astype(np.float32) / np.float32(1 << 20)
        ia = (fa * np.float32(63)).astype(np.int64)
        ib = (fb * np.float32(63)).astype(np.int64)

        tile_ab = np.stack([tile[pa], tile[pb]], axis=-1)
        bb = (minA, minB, maxA, maxB)

        found = None
        found_e = -1
        diff_best = None
        for e in range(bank.count):
            ctx = bank.ctxs[e]
            mode8 = get_evaluation(score_patterns(ia, ib, ctx.dist_field))
            m, diff_sum, values = compute_values(tile_ab, mask, mode8, bb, ctx)
            # later pattern with EQUAL diffSum replaces (<=, :7032)
            if m != SKIP and (diff_best is None or diff_sum <= diff_best):
                found = (mode8, m, values)
                found_e = e
                diff_best = diff_sum
        if found is None:
            continue
        mode8, m, values = found
        streams["color"] += bytes((minA, minB, maxA, maxB))
        # u16: bits 0..2 pattern8, 3..13 LUT id, 14..15 bit mode (:7088)
        streams["type"].append(mode8 | (found_e << 3) | (m << 14))
        bit = m + 3
        streams[bit] += values[bit].tobytes()
        bitmap_bits[i] = True
        claims[pa, y:y + th, x:x + tw] = True   # whole tile, both planes
        claims[pb, y:y + th, x:x + tw] = True   # (:7243-7270)

    packed = np.frombuffer(swizzle.pack_bitmap(bitmap_bits), np.uint8)
    mbuf = streams["maps"][(sx, sy)]
    mbuf[:len(packed)] |= packed
