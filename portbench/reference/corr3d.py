"""Correlation3DSearch: the 3D-LUT tile pass on the host (numpy).

A frozen copy of the port's `encoder/corr3d.py`: the host encode engine's
3D scorer (`encode_image(..., engine="host")`), which shares no code with
the scoring kernels. `PERMS48` also builds their tables
(`encoder/tables.py`). Mirrors reference `EncoderContext.cpp:6245-6790`
(+ buildBBox3D :132, computeValues3D :5807-6094,
EvalCtx3D::EvaluatePoint3D / GetEvaluation3D EncoderContext.h:627-710,
swap3D :5314).

Two reference quirks preserved deliberately:
- EvaluatePoint3D mutates its coordinates cumulatively across the 48
  pattern iterations, so the scored transforms are NOT the clean 48
  symmetries; PERMS48 below is the exact effective permutation per pattern.
- The scoring distance field is the 3-bit (8-point) one (Set3DPointCloud
  overwrites the field per bit level, 3-bit last).
"""
from __future__ import annotations

import numpy as np

from portbench.reference import swizzle

FACTOR = 128
SKIP = 4  # SKIP_TOO_LOSSY

# swap3D permutations (single application): values (x,y,z) -> (v[p0],v[p1],v[p2])
SWAP3D = {
    0: (0, 1, 2),
    1: (0, 2, 1),
    2: (1, 0, 2),
    3: (1, 2, 0),
    4: (2, 0, 1),
    5: (2, 1, 0),
}


def _perms48():
    """Effective value permutation per scoring pattern n (0..47), derived
    from EvaluatePoint3D's cumulative in-place swaps (EncoderContext.h:627)."""
    perms = []
    state = (0, 1, 2)
    ops = {1: (0, 2, 1), 2: (1, 0, 2), 3: (1, 2, 0), 4: (2, 0, 1), 5: (2, 1, 0)}
    for n in range(48):
        grp = n >> 3
        if grp in ops:
            o = ops[grp]
            state = (state[o[0]], state[o[1]], state[o[2]])
        perms.append(state)
    return perms


PERMS48 = _perms48()


def score_patterns(ir, ig, ib, dist_field):
    """sumDistance3D for all 48 patterns. ir/ig/ib: i64 arrays of pixel
    coords (0..63); dist_field: i32 [64^3] flat (x + y*64 + z*4096)."""
    sums = np.empty(48, np.int64)
    coords = (ir, ig, ib)
    for n in range(48):
        p = PERMS48[n]
        x, y, z = coords[p[0]], coords[p[1]], coords[p[2]]
        if n & 1:
            x = 63 - x
        if n & 2:
            y = 63 - y
        if n & 4:
            z = 63 - z
        sums[n] = dist_field[x + (y << 6) + (z << 12)].sum()
    return sums


def get_evaluation(sums, sample_count):
    """GetEvaluation3D: argmin of float32 sum/(count*1024.0f), strict <."""
    avg = sums.astype(np.float32) / np.float32(sample_count * 1024.0)
    best, res = np.float32(999999999.0), -1
    for f in range(48):
        if avg[f] < best:
            best = avg[f]
            res = f
    return res, best


def compute_values(tile_rgb, mask, mode, bb, ctx):
    """computeValues3D (:5807). tile_rgb: i64 [th, tsx_full, 3] raw pixel
    values (tsx_full up to 16); mask: bool [th, tsx_full] True = skip.
    Returns (m, diff_sum, values dict bit->u8 idx array in stream order)."""
    x0 = np.array([bb[0], bb[1], bb[2]], np.int64)
    d = np.array([bb[3] - bb[0], bb[4] - bb[1], bb[5] - bb[2]], np.int64)

    th, tsx = mask.shape
    # iteration order: xa blocks of 8 columns, then rows, then columns
    cols = []
    if tsx > 8:
        for xa in range(2):
            sub = ~mask[:, xa * 8:(xa + 1) * 8]
            ys, xs = np.nonzero(sub)
            cols.append((ys, xs + xa * 8))
    else:
        ys, xs = np.nonzero(~mask)
        cols.append((ys, xs))
    ys = np.concatenate([c[0] for c in cols])
    xs = np.concatenate([c[1] for c in cols])
    if ys.size == 0:
        return SKIP, 0, {}

    rgb = tile_rgb[ys, xs]                       # [n, 3] stream order
    rel = (rgb - x0[None, :]).astype(np.float32)
    dd = d.astype(np.float32)
    for c in range(3):
        if d[c]:
            rel[:, c] = rel[:, c] / dd[c]
    rel = rel * np.float32(63.0)

    flips = (mode & 1, mode & 2, mode & 4)
    m3 = np.empty((len(rgb), 3), np.int64)
    for c in range(3):
        if flips[c]:
            m3[:, c] = (np.float32(63.0) - rel[:, c]).astype(np.int64)
        else:
            m3[:, c] = rel[:, c].astype(np.int64)
    p = SWAP3D[mode >> 3]
    mx, my, mz = m3[:, p[0]], m3[:, p[1]], m3[:, p[2]]

    values = {}
    reject = 0
    diffs = {}
    for bi, bit in enumerate((6, 5, 4, 3)):
        idx = ctx.position[bit][mz, my, mx]      # [n]
        values[bit] = idx.astype(np.uint8)
        f = ctx.factors[bit][idx].astype(np.int64)   # [n, 3] x,y,z factors
        fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
        if mode & 1:
            fx = FACTOR - fx
        if mode & 2:
            fy = FACTOR - fy
        if mode & 4:
            fz = FACTOR - fz
        fs = np.stack([fx, fy, fz], axis=1)
        fs = fs[:, [p[0], p[1], p[2]]]
        recon = x0[None, :] + (fs * d[None, :]) // FACTOR
        ldiff = np.abs(recon - rgb).max(axis=1)      # [n]
        diffs[bit] = int(ldiff.sum())
        # wrongPixel counting with early-exit-at-row-end semantics: the
        # early exit only affects SKIP results, so a simple count suffices
        if int((ldiff > 5).sum()) > 3:
            reject |= 1 << bi
    m = SKIP
    diff_sum = 0
    # preference order: last non-rejected of 6,5,4,3 wins -> fewest bits
    mode_of = {6: 3, 5: 2, 4: 1, 3: 0}
    for bi, bit in enumerate((6, 5, 4, 3)):
        if not (reject & (1 << bi)):
            m = mode_of[bit]
            diff_sum = diffs[bit]
    return m, diff_sum, values


def run_pass(planes, claims, bank, sx, sy, streams):
    """One Correlation3DSearch size pass.

    planes: [3,H,W] int32; claims: [3,H,W] bool (mapSmoothTile);
    bank: encoder.bank.Bank; streams: dict with keys 'color' (bytearray),
    'type' (list of u16), 3/4/5/6 (bytearray of raw indices), and
    'maps' dict (sx,sy)->np.uint8 array (bits-as-bytes-sized bitmap).
    """
    tw, th = 1 << sx, 1 << sy
    _, h, w = planes.shape
    tx_all, ty_all, valid = swizzle.tile_scan_coords(sx, sy, w, h)
    inside = ((tx_all + 1) * tw <= w) & ((ty_all + 1) * th <= h)

    bitmap_bits = np.zeros(tx_all.shape[0], bool)
    n_ctx = bank.count

    for i in np.flatnonzero(valid & inside):
        tx, ty = int(tx_all[i]), int(ty_all[i])
        x, y = tx * tw, ty * th
        tile = planes[:, y:y + th, x:x + tw].transpose(1, 2, 0).astype(np.int64)
        mask = claims[:, y:y + th, x:x + tw].all(axis=0)  # all 3 planes white
        if mask.all():
            continue
        sel = ~mask
        pix = tile[sel]                                   # [n,3]
        mn = pix.min(axis=0)
        mx = pix.max(axis=0)
        dx, dy, dz = (mx - mn).tolist()
        flat = sum(1 for v in (dx, dy, dz) if v == 0)
        if flat >= 2 or (not sel.any()):
            continue

        # normalized scoring coords (fixed-point then float32, :6345-6400)
        nvec = np.array([(1 << 20) // v if v else 0 for v in (dx, dy, dz)],
                        np.int64)
        r = (pix - mn[None, :]) * nvec[None, :]
        fr = r.astype(np.float32) / np.float32(1 << 20)
        i64 = (fr * np.float32(63)).astype(np.int64)
        ir, ig, ib = i64[:, 0], i64[:, 1], i64[:, 2]

        bb = (int(mn[0]), int(mn[1]), int(mn[2]),
              int(mx[0]), int(mx[1]), int(mx[2]))

        found = None
        found_e = -1
        diff_best = 1215752191  # (int)99999999999 truncated, :6459
        for e in range(n_ctx):
            ctx = bank.ctxs[e]
            sums = score_patterns(ir, ig, ib, ctx.dist_field)
            mode48, _score = get_evaluation(sums, len(pix))
            m, diff_sum, values = compute_values(tile, mask, mode48, bb, ctx)
            if m != SKIP and diff_sum <= diff_best:
                found = (mode48, m, values)
                found_e = e
                diff_best = diff_sum

        if found is None:
            continue
        mode48, m, values = found
        streams["color"] += bytes(bb)
        streams["type"].append(mode48 | (found_e << 6) | (m << 14))
        bit = m + 3
        streams[bit] += values[bit].tobytes()
        bitmap_bits[i] = True
        claims[:, y:y + th, x:x + tw] = True

    # write bits into the pass's (8x padded) map
    packed = np.frombuffer(swizzle.pack_bitmap(bitmap_bits), np.uint8)
    m = streams["maps"][(sx, sy)]
    m[:len(packed)] |= packed
