"""DynamicTileEncode: range-coded Y/Co/Cg 8x8 tiles -> PLNT chunks.

The port's copy of `yaik_tpu/encoder/plnt.py`.

Re-expresses the reference's disabled YCoCg path (EncoderContext.cpp:
4365-4602 entry, GetTileDynamic_Y :747-1212, DynamicTile::buildTable
:625-699, call block inside `#if 0` at :9539-9545). Byte-exact vs the
compiled reference pass (tools/ref_encode_plnt_main.cpp goldens).

Reference facts worth knowing:
- DynamicTileEncoderTable() (the LUT-bank init) is itself commented out in
  LoadImagePNG (:1229) - re-enabling just the call block would run on
  all-zero tables. The reference harness and this module build the tables.
- the 256x256 build loop over a DynamicTile[255][255] array writes row 255
  and every [m][255] slot out of bounds, but lookups use identical
  addressing, so the effective table for ANY (min, max) is exactly
  buildTable(min, max) (the overflow only stomps unrelated research-path
  globals). We therefore model tables functionally.
- despite the names, base7Bit is 6-bit (x63/224) and distance6Bit is 7-bit
  (x127); the tile type word is mode<<13 | range<<7 | base (EncodeTileType,
  YAIK_private.h:358).
- buildTable clamps diff at 16 (:640) but DiffRangeEncode clamps at
  MIN_DIFF_RANGE=32 (:580,606) - both kept.
- LUT curves use float32 powf(pos, 1.4f); we call libm's powf via ctypes
  for bit-exact tables.
- mode selection is errorDist <= best with modes 0..5 in order, so 3-bit
  curves win ties; errorDist accumulates float32 minDiff/value in pixel
  scan order.
- signed planes (Co/Cg tiles with min < 0) shift into 0..255 space and the
  stream does NOT record it: PLNT never had a decoder, and the sign is
  unrecoverable at decode (the encoder's own preview at :4444 guesses).
"""
from __future__ import annotations

import ctypes
import ctypes.util
from functools import lru_cache

import numpy as np

from yaik_tpu_torch.entropy import zstd_backend as zstd
from yaik_tpu_torch.format.headers import HeaderBase, PlaneTile
from yaik_tpu_torch.ops import plane as ops

MAX_BASE_RANGE = 224
MIN_DIFF_RANGE = 32
BASE_MAX_ENC = 63      # (1<<6)-1
RANGE_MAX_ENC = 127    # (1<<7)-1

_libm = ctypes.CDLL(ctypes.util.find_library("m"))
_libm.powf.restype = ctypes.c_float
_libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]


def _powf(x: float, y: float) -> float:
    return _libm.powf(ctypes.c_float(x), ctypes.c_float(y))


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncate toward zero). BN can exceed 255-32,
    making DiffRangeEncode/Decode's scale NEGATIVE (e.g. min >= 224) -
    C's -2/127 == 0 while Python's floors to -1."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def min_range_encode(v: int) -> int:
    v = min(v, MAX_BASE_RANGE)
    return (v * BASE_MAX_ENC + MAX_BASE_RANGE // 2) // MAX_BASE_RANGE


def min_range_decode(v: int) -> int:
    return (v * MAX_BASE_RANGE) // BASE_MAX_ENC


def diff_range_encode(diff: int, bn: int) -> int:
    diff = max(diff, MIN_DIFF_RANGE)
    scale = (255 - MIN_DIFF_RANGE) - bn
    return _cdiv((diff - MIN_DIFF_RANGE) * RANGE_MAX_ENC + (scale - 1), scale)


def diff_range_decode(v: int, bn: int) -> int:
    scale = (255 - MIN_DIFF_RANGE) - bn
    return _cdiv(v * scale, RANGE_MAX_ENC) + MIN_DIFF_RANGE


@lru_cache(maxsize=None)
def curves_from(bn: int, dist: int):
    """The 6 mode LUTs (Linear/Exp/Log at 4 bit then 3 bit, GetTable order)
    for a decoded (BN, rangeDecode) pair. All arithmetic in float32 like
    the C expressions, including the final (int)(BN + out) truncation."""
    bn32 = np.float32(bn)
    dist32 = np.float32(float(dist))

    def curve(count):
        lin, exp, log = [], [], []
        for i in range(count):
            pos = np.float32(i) / np.float32(count - 1)
            lin.append(int(bn32 + pos * dist32))
            e = np.float32(_powf(float(pos), 1.4))
            exp.append(int(bn32 + e * dist32))
            lg = np.float32(1.0) - np.float32(
                _powf(float(np.float32(1.0) - pos), 1.4))
            log.append(int(bn32 + lg * dist32))
        return tuple(lin), tuple(exp), tuple(log)

    lin4, exp4, log4 = curve(16)
    lin3, exp3, log3 = curve(8)
    return (lin4, exp4, log4, lin3, exp3, log3)


@lru_cache(maxsize=None)
def build_table(mn: int, mx: int):
    """DynamicTile::buildTable -> (base6, range7, luts)."""
    if mn < 0 or mx < mn or mx > 255:
        return None
    mn_c = min(mn, MAX_BASE_RANGE)
    diff = max(mx - mn_c, 16)
    base = min_range_encode(mn_c)
    bn = min_range_decode(base)
    rng = diff_range_encode(diff, bn)
    dist = diff_range_decode(rng, bn)
    return base, rng, curves_from(bn, dist)


def _tile_search(vals: np.ndarray, mn: int, mx: int, start_mode: int):
    """GetTileDynamic_Y mode loop. vals: i64 [n] valid pixel values in scan
    order (already +128 when signed). Returns (mode, codes [n] u8)."""
    base, rng, luts = build_table(mn, mx)
    best_mode = -1
    best_err = np.float32(99999999.0)
    best_codes = None
    for mode in range(start_mode, 6):
        lut = np.asarray(luts[mode], np.int64)
        d = np.abs(lut[None, :] - vals[:, None])
        codes = d.argmin(axis=1)                    # first min = strict <
        mind = d[np.arange(len(vals)), codes]
        with np.errstate(divide="ignore", invalid="ignore"):
            contrib = np.where(vals != 0,
                               mind.astype(np.float32)
                               / vals.astype(np.float32),
                               np.float32(0.0))
        err = (np.add.accumulate(contrib.astype(np.float32))[-1]
               if len(contrib) else np.float32(0.0))
        if err <= best_err:                          # later mode wins ties
            best_err = err
            best_mode = mode
            best_codes = codes
    return best_mode, best_codes, base, rng


def encode_plane(src: np.ndarray, valid: np.ndarray, bound,
                 is_co: bool, is_cg: bool, half_x: bool, half_y: bool,
                 mode_3bit_only: bool) -> bytes:
    """One DynamicTileEncode call -> one PLNT chunk.

    src: i32 [h, w] plane (possibly chroma-reduced, signed for Co/Cg);
    valid: full-res [H, W] bool (the mipmapMask); bound: (x0, y0, x1, y1)
    full-res pixel bounds (boundX0..boundY1)."""
    h, w = src.shape
    vh, vw = valid.shape
    sx_shift = 1 if half_x else 0
    sy_shift = 1 if half_y else 0

    x0, y0, x1, y1 = bound
    cx = (x0 >> 3) << 3
    cy = (y0 >> 3) << 3
    cw = (((x1 + 7) >> 3) << 3) - cx
    ch = (((y1 + 7) >> 3) << 3) - cy
    if half_x:
        cx >>= 1
        cw >>= 1
    if half_y:
        cy >>= 1
        ch >>= 1

    flat_valid = valid.reshape(-1)

    def pixel_valid(sx, sy):
        # GetTileDynamic_Y's validity (:826-861); the smooth plane is NULL
        # in the canonical flow, so only the validPixel test remains. Note
        # the index uses the FULL mask width (w of validPixel).
        idx = (sx << sx_shift) + (sy << sy_shift) * vw
        return bool(flat_valid[idx]) if idx < flat_valid.size else False

    def minmax_valid(sx, sy):
        # Plane::GetMinMax_Y (:489) indexes the mask with THIS (possibly
        # half-res) plane's width - a reference bug kept for parity
        idx = (sx << sx_shift) + (sy << sy_shift) * w
        return bool(flat_valid[idx]) if idx < flat_valid.size else False

    start_mode = 3 if mode_3bit_only else 0
    tile_types = []
    nibbles = []

    for ty in range(cy, cy + ch, 8):
        if ty >= h:
            break
        for tx in range(cx, cx + cw, 8):
            if tx >= w:
                continue
            bw = min(8, w - tx)
            bh = min(8, h - ty)
            # GetMinMax_Y over the tile
            mn, mx = 99999999, -99999999
            any_valid = False
            for y in range(ty, min(ty + bh, h)):
                for x in range(tx, min(tx + bw, w)):
                    if minmax_valid(x, y):
                        v = int(src[y, x])
                        mn = min(mn, v)
                        mx = max(mx, v)
                        any_valid = True
            if not any_valid:
                mn, mx = 0, 0

            use_signed = mn < 0
            if use_signed:
                mn += 128
                mx += 128

            # collect valid pixels in scan order (GetTileDynamic_Y loop)
            vals = []
            for y in range(bh):
                for x in range(bw):
                    if pixel_valid(tx + x, ty + y):
                        v = int(src[ty + y, tx + x]) + (128 if use_signed
                                                        else 0)
                        vals.append(v)
            vals = np.asarray(vals, np.int64)
            mode, codes, base, rng = _tile_search(vals, mn, mx, start_mode)
            if len(vals):
                tile_types.append((mode << 13) | (rng << 7) | base)
                nibbles.extend(int(c) for c in codes)

    # nibble-pack (4 bits each regardless of mode, :1176-1183), pad to byte
    if len(nibbles) & 1:
        nibbles.append(0)
    packed = bytearray(len(nibbles) >> 1)
    for i, c in enumerate(nibbles):
        if i & 1:
            packed[i >> 1] |= c << 4
        else:
            packed[i >> 1] |= c
    types = np.asarray(tile_types, "<u2").tobytes()

    dw, dh = w // 8, h // 8
    z_types = zstd.compress(types, 21, dw * dh * 3)
    z_idx = zstd.compress(bytes(packed), 21, dw * dh * 64)

    plane_id = 1 if is_co else (2 if is_cg else 0)
    hdr = PlaneTile(
        x=cx, y=cy, w=cw, h=ch,
        stream_size_tile_map=len(z_types),
        stream_size_tile_stream=len(z_idx),
        expected_size_tile_stream=len(packed),
        version=1,
        format=(plane_id << 2) | (1 if half_x else 0) | (2 if half_y else 0))
    body = hdr.pack() + z_types + z_idx
    length = (len(body) + 3) & ~3
    return (HeaderBase(b"PLNT", length).pack() + body
            + b"\0" * (length - len(body)))


def encode_plnt(planes: np.ndarray, mip_mask: np.ndarray | None,
                bound, half_co_w=True, half_co_h=False,
                half_cg_w=True, half_cg_h=False) -> bytes:
    """The #if 0 block (:9539-9545): chromaReduction then Y/Co/Cg chunks."""
    _, h, w = planes.shape
    if mip_mask is None:
        mip_mask = np.ones((h, w), bool)
    yy, co, cg = ops.rgb_to_ycocg(planes[0], planes[1], planes[2])
    work_co = ops.sample_down(co, half_co_w, half_co_h, "average")
    work_cg = ops.sample_down(cg, half_cg_w, half_cg_h, "average")
    out = bytearray()
    out += encode_plane(yy, mip_mask, bound, False, False, False, False,
                        False)
    out += encode_plane(work_co, mip_mask, bound, True, False,
                        half_co_w, half_co_h, False)
    out += encode_plane(work_cg, mip_mask, bound, False, True,
                        half_cg_w, half_cg_h, True)
    return bytes(out)
