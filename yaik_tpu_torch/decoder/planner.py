"""Decode planner: host-side conversion of a .yaik stream into dense,
device-ready tensors. The port's copy of `yaik_tpu/decoder/planner.py`
(it reads the chunk walk of the port's host decoder, `reference.py`, as the
JAX package's planner does).

The sequential parts of YAIK decoding - zstd, the palette codec, corner
dedup, quad-claim replay, and the shared index-stream cursors - are all
O(tiles), not O(pixels). This module runs them once on the host (numpy) and
emits a DecodePlan that is DENSE over the full tile grid of each pass;
`pack.plan_to_args` turns it into the kernels' operands.

  - per gradient pass: corner-color grid snapshot + accept grid
  - per 3D size pass: accept grid, per-tile 64-entry LUT slices, min/max
    colors, dense per-tile index bytes (stream bytes host-reordered into
    tile-pixel slots), and per-pixel write masks
  - 1D pass: per-8x8-tile params + dense index bytes + write masks, x3 planes

Everything is vectorized over the accepted-tile list of each pass: claims
only ever flip quads of ACCEPTED tiles and same-pass tiles are disjoint, so
the claim state any tile observes is the pass-entry snapshot - which makes
the whole cursor replay expressible as cumsums + fancy indexing (the
reference decodes tile-by-tile, YAIK_API.cpp:1349+; same values by
construction, checked bit-exactly in tests).

Held field by field against the JAX package's planner in the tests.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from yaik_tpu_torch import native
from yaik_tpu_torch.decoder.reference import (_PAIR2D, _PAIR_ORDER,
                                              decode_smap_seeds,
                                              decode_ucol_map, iter_chunks)
from yaik_tpu_torch.entropy import palette, zstd_backend as zstd
from yaik_tpu_torch.format import swizzle
from yaik_tpu_torch.format.headers import (AlphaHeader, FileHeader, Header1D,
                                           HeaderGradientTile,
                                           HeaderSmoothMap, HeaderTile3D,
                                           HeaderTile3DX, MAGIC,
                                           MipmapHeader, PlaneTile,
                                           UniqueColorHeader)
from yaik_tpu_torch.ops.plane import ycocg_to_rgb
from yaik_tpu_torch.utils import profiler


@dataclass
class GradientPassPlan:
    shift: tuple          # (sx, sy)
    accept: np.ndarray    # [nty, ntx] bool
    corners: np.ndarray   # [nqy+1, nqx+1, 3] u8 corner grid snapshot
    plane_mask: int = 7   # present planes (GTIL plane field)


@dataclass
class Tile3DPassPlan:
    shift: tuple
    accept: np.ndarray    # [nty, ntx] bool
    colors: np.ndarray    # [nty*ntx, 6] i32 (min RGB, max RGB)
    packed: np.ndarray    # [nty*ntx, th*tw] u8: LUT idx (6 bits, clamped)
                          #   | wmask << 6 - the device-link layout
    types: np.ndarray = None  # [nty*ntx] i32 raw tile type words (stats)


@dataclass
class Tile2DPassPlan:
    mode: int             # 0 RG, 1 GB, 2 RB (plane pair)
    shift: tuple          # (3, 3) or (2, 2)
    accept: np.ndarray    # [nty, ntx] bool
    types: np.ndarray     # [nty*ntx] i32 raw tile type words
    colors: np.ndarray    # [nty*ntx, 4] i32 (minA, minB, maxA, maxB)
    packed: np.ndarray    # [nty*ntx, th*tw] u8 idx | wmask<<6


@dataclass
class PlanOverlay:
    """Pre-pass pixel overlay in stream order: UCOL palette pixels and SMAP
    seed points (both precede the gradient/3D/1D chunks and make no
    claims)."""
    vals: np.ndarray      # [h8, w8, 3] u8
    mask: np.ndarray      # [h8, w8] bool


@dataclass
class Plan1D:
    params: np.ndarray    # [3, nT, 3] i32 (color0, base, delta2)
    indices: np.ndarray   # [3, nT, 64] u8
    wmask: np.ndarray     # [3, nT, 64] bool


@dataclass
class MipPlan:
    """MIPM chunk in device-ready form (bit expansion happens on device)."""
    bits: np.ndarray      # packed tile bits (LSB-first)
    grid: tuple           # (mw, mh) tiles
    origin: tuple         # (x0, y0) px
    level: int            # log2 tile size (4 -> 16 px)


@dataclass
class AlphaPlan:
    """ALPM chunk in device-ready form: the zstd payload plus the static
    (mode, bbox) spec; bit expansion / sparse placement happen on device
    (YAIK_Alpha.cpp:25-377 hot loops). decoder/alpha.py stays the host
    byte-level reference."""
    mode: int             # AlphaHeader mode (1..6)
    bbox: tuple           # (x, y, w, h)
    raw: np.ndarray       # [needed] u8, zero-padded to the mode's size
    mip: MipPlan | None   # required by the sparse modes (2, 3)


@dataclass
class DecodePlan:
    width: int
    height: int
    gradient: list        # list[GradientPassPlan]
    tile3d: list          # list[Tile3DPassPlan]
    d1: Plan1D
    has_alpha: bool = False
    alpha_plan: AlphaPlan | None = None   # None + has_alpha -> constant 255
    overlay: PlanOverlay | None = None
    tile2d: list | None = None        # list[Tile2DPassPlan] (6 when present)
    _alpha_arr: np.ndarray | None = None

    def host_alpha(self) -> np.ndarray | None:
        """[H, W] u8 alpha decoded on the host (lazy, cached) - for the
        spatial-band path and mixed-spec batches; the jax engine decodes
        alpha on device from alpha_plan."""
        if not self.has_alpha:
            return None
        if self._alpha_arr is None:
            from yaik_tpu_torch.decoder.alpha import alpha_plan_to_channel
            self._alpha_arr = alpha_plan_to_channel(
                self.alpha_plan, self.width, self.height)
        return self._alpha_arr


# Quad-pair layout cases (which halves of a 4x8 pair / 4x4 single still need
# stream bytes given the claim bits): case id -> consumed byte count.
_CASE_NONE, _CASE_FULL, _CASE_LEFT, _CASE_RIGHT, _CASE_SINGLE = 0, 1, 2, 3, 4
_CASE_BYTES = np.asarray([0, 32, 16, 16, 16], np.int64)

_LAYOUT_CACHE: dict = {}


def _case_slots(case: int, gx0: int, gy0: int, tw: int) -> np.ndarray:
    """Row-major tile-pixel slots written by one pair/single case (the
    4x4-quad scan layout of ReadQuadTile, YAIK_API.cpp:1248-1320)."""
    key = (case, gx0, gy0, tw)
    if key not in _LAYOUT_CACHE:
        if case == _CASE_FULL:
            ys, xs = np.mgrid[0:4, 0:8]
            slots = (ys + gy0 * 4) * tw + xs + gx0 * 4
        elif case in (_CASE_LEFT, _CASE_SINGLE):
            ys, xs = np.mgrid[0:4, 0:4]
            slots = (ys + gy0 * 4) * tw + xs + gx0 * 4
        else:  # _CASE_RIGHT
            ys, xs = np.mgrid[0:4, 0:4]
            slots = (ys + gy0 * 4) * tw + xs + (gx0 + 1) * 4
        _LAYOUT_CACHE[key] = slots.reshape(-1)
    return _LAYOUT_CACHE[key]


def _claim_tiles(claims, qx0, qy0, tw, th):
    """Set the quad-claim bits of accepted tiles (clips at the grid edge,
    matching the reference's slice semantics for partially-inside tiles)."""
    dq = np.mgrid[0:th // 4, 0:tw // 4]
    qy = qy0[:, None, None] + dq[0]
    qx = qx0[:, None, None] + dq[1]
    ok = (qy < claims.shape[0]) & (qx < claims.shape[1])
    claims[qy[ok], qx[ok]] = True


def _group_cases(claims, qx0, qy0, pairs):
    """Per accepted tile x pair-group: case ids [n, G] from the quad-claim
    snapshot (within one pass tiles are disjoint, so the snapshot is what
    every tile observes)."""
    n = qx0.shape[0]
    cases = np.zeros((n, len(pairs)), np.int8)
    for g, group in enumerate(pairs):
        if len(group) == 2:
            (gx0, gy0), (gx1, _) = group
            b0 = claims[qy0 + gy0, qx0 + gx0]
            b1 = claims[qy0 + gy0, qx0 + gx1]
            cases[:, g] = np.where(
                ~b0 & ~b1, _CASE_FULL,
                np.where(~b0, _CASE_LEFT,
                         np.where(~b1, _CASE_RIGHT, _CASE_NONE)))
        else:
            (gx0, gy0), = group
            b0 = claims[qy0 + gy0, qx0 + gx0]
            cases[:, g] = np.where(b0, _CASE_NONE, _CASE_SINGLE)
    return cases


def _scatter_streams(cases, pairs, tw, base_off, gid, source, dst_idx,
                     dst_mask, premultiplied):
    """Copy stream bytes into dense per-tile slots: one vectorized scatter
    per (group, case) combination. base_off [n] i64 absolute stream offsets
    of each tile's first byte; within-tile group offsets are the prefix sums
    of the per-group consumed counts."""
    within = np.zeros(cases.shape, np.int64)
    np.cumsum(_CASE_BYTES[cases[:, :-1]], axis=1, out=within[:, 1:])
    for g, group in enumerate(pairs):
        gx0, gy0 = group[0]
        group_cases = ((_CASE_SINGLE,) if len(group) == 1
                       else (_CASE_FULL, _CASE_LEFT, _CASE_RIGHT))
        for case in group_cases:
            m = cases[:, g] == case
            if not m.any():
                continue
            slots = _case_slots(case, gx0, gy0, tw)
            pos = (base_off[m] + within[m, g])[:, None] + \
                np.arange(slots.size)
            vals = source[pos]
            dst_idx[gid[m][:, None], slots[None, :]] = \
                vals // 3 if premultiplied else vals
            dst_mask[gid[m][:, None], slots[None, :]] = True


def build_plan(stream: bytes, luts_expanded: dict,
               luts2d_expanded: dict | None = None) -> DecodePlan:
    fh = FileHeader.unpack(stream)
    if fh.tag != MAGIC:
        raise ValueError("not a YAIK stream")
    w, h = fh.width, fh.height
    stride_q = w // 4 + 1
    nq = stride_q * (h // 4 + 1)

    map_rgb = np.zeros((nq, 3), np.uint8)
    has_rgb = np.zeros(nq, bool)               # shared until the first
    has_rgb3 = None                            # plane-variant GTIL chunk
    claims = np.zeros(swizzle.claim_shape(w, h), bool)
    claims3 = None                             # split on first 2DTL chunk

    grads: list[GradientPassPlan] = []
    t3passes: list[Tile3DPassPlan] = []
    t2passes: list[Tile2DPassPlan] = []
    overlay = None

    def get_overlay():
        nonlocal overlay
        if overlay is None:
            h8, w8 = ((h + 7) // 8) * 8, ((w + 7) // 8) * 8
            overlay = PlanOverlay(vals=np.zeros((h8, w8, 3), np.uint8),
                                  mask=np.zeros((h8, w8), bool))
        return overlay
    # correctly-shaped empty default: streams with no 1DTL chunk (fully
    # gradient/3D-claimed images) must still feed the dense device kernel
    _g1 = max(1, (h // 8) * (w // 8))
    d1 = Plan1D(params=np.zeros((3, _g1, 3), np.int32),
                indices=np.empty((3, _g1, 64), np.uint8),  # wmask-gated
                wmask=np.zeros((3, _g1, 64), bool))
    alpha_plan = None
    mip_plan = None

    import struct as _struct

    def _chunks_checked(st):
        try:
            yield from iter_chunks(st)
        except _struct.error as e:
            raise ValueError(f"malformed chunk: {e}") from e

    for tag, off, body in _chunks_checked(stream):
      try:
        if tag == b"GTIL":
            hdr = HeaderGradientTile.unpack(body)
            payload = body[HeaderGradientTile.size():]
            sx, sy = hdr.shift_x, hdr.shift_y
            tw, th = 1 << sx, 1 << sy
            bitmap = zstd.decompress_arr(
                payload[:hdr.stream_bitmap_size],
                swizzle.bitmap_size_bytes(sx, sy, w, h))
            cust = zstd.decompress(
                payload[hdr.stream_bitmap_size:
                        hdr.stream_bitmap_size + hdr.stream_rgb_size_zstd],
                hdr.stream_rgb_size_custom)
            rgb = palette.palette_decompress(
                cust, hdr.stream_rgb_size_uncompressed, hdr.color_compression)

            if hdr.plane == 7 and native.available():
                # consolidated native pass: bitmap walk + corner dedup +
                # claims + accept grid in ONE call (planning is decode's
                # host bottleneck; the numpy path below is the reference)
                expect = swizzle.bitmap_size_bytes(sx, sy, w, h)
                mb = np.ascontiguousarray(bitmap[:expect])
                if mb.size != expect:
                    raise ValueError(f"bitmap size {mb.size} != {expect}")
                bx, by, _bits = swizzle.swizzle_spec(sx, sy)
                grid = np.zeros(((h + th - 1) // th, (w + tw - 1) // tw),
                                bool)
                native.plan_gtil_full(mb, w, h, sx, sy, bx, by, rgb,
                                      map_rgb, has_rgb.view(np.uint8),
                                      stride_q, claims.view(np.uint8),
                                      grid.view(np.uint8))
                grads.append(GradientPassPlan(
                    shift=(sx, sy), accept=grid,
                    corners=map_rgb.reshape(h // 4 + 1, stride_q, 3).copy()))
                continue
            # security offset like the reference (YAIK_API.cpp:896-910):
            # corrupted bitmaps may claim more corners than the stream holds;
            # over-allocate so reads get zeros instead of faulting (the
            # native path above bound-checks instead)
            rgb = np.concatenate(
                [rgb, np.zeros(3 * ((w // 4 + 1) * (h // 4 + 1)), np.uint8)])
            rgb3 = rgb[:(rgb.size // 3) * 3].reshape(-1, 3)
            grid, _ = swizzle.accept_grid(bitmap, sx, sy, w, h)
            tx_all, ty_all, valid = swizzle.tile_scan_coords(sx, sy, w, h)
            bits = swizzle.unpack_bitmap(bitmap, sx, sy, w, h)
            acc = np.flatnonzero(bits & valid)
            if hdr.plane != 7:
                # plane-variant chunk (opt-in streams): per-plane corner
                # dedup/cursor and claims, mirroring the host decoder
                # (reference.py _gradient_chunk). Split shared state first.
                if has_rgb3 is None:
                    has_rgb3 = np.repeat(has_rgb[None], 3, axis=0).copy()
                if claims3 is None:
                    claims3 = np.repeat(claims[None], 3, axis=0).copy()
                present = [p for p in range(3) if hdr.plane & (1 << p)]
                flat_rgb = rgb
                cursor = 0
                for i in acc:
                    txi, tyi = int(tx_all[i]), int(ty_all[i])
                    qx, qy = txi * (tw // 4), tyi * (th // 4)
                    base = qy * stride_q + qx
                    for cid in (base, base + tw // 4,
                                base + (th // 4) * stride_q,
                                base + (th // 4) * stride_q + tw // 4):
                        for p in present:
                            if not has_rgb3[p][cid]:
                                has_rgb3[p][cid] = True
                                map_rgb[cid, p] = flat_rgb[cursor]
                                cursor += 1
                    for p in present:
                        claims3[p][qy:qy + th // 4, qx:qx + tw // 4] = True
                grads.append(GradientPassPlan(
                    shift=(sx, sy), accept=grid,
                    corners=map_rgb.reshape(h // 4 + 1, stride_q, 3).copy(),
                    plane_mask=hdr.plane))
                continue
            if acc.size:
                tx, ty = tx_all[acc], ty_all[acc]
                qx0, qy0 = tx * (tw // 4), ty * (th // 4)
                base = qy0.astype(np.int64) * stride_q + qx0
                # the 4 corner ids per tile in LT, RT, LB, RB read order
                ids = np.stack([base, base + tw // 4,
                                base + (th // 4) * stride_q,
                                base + (th // 4) * stride_q + tw // 4],
                               axis=1).reshape(-1)
                # first-touch dedup in scan order == the reference's
                # "read next rgb if corner not yet loaded" cursor
                _, first = np.unique(ids, return_index=True)
                isfirst = np.zeros(ids.size, bool)
                isfirst[first] = True
                new = isfirst & ~has_rgb[ids]
                k = np.cumsum(new) - 1
                map_rgb[ids[new]] = rgb3[k[new]]
                has_rgb[ids[new]] = True
                _claim_tiles(claims, qx0, qy0, tw, th)
            grads.append(GradientPassPlan(
                shift=(sx, sy), accept=grid,
                corners=map_rgb.reshape(h // 4 + 1, stride_q, 3).copy()))

        elif tag in (b"3DTL", b"3DTX"):
            cls = HeaderTile3D if tag == b"3DTL" else HeaderTile3DX
            hdr = cls.unpack(body)
            t3passes = _plan_3d(body[cls.size():], hdr, w, h,
                                claims, luts_expanded)

        elif tag == b"2DTL":
            if luts2d_expanded is None:
                raise ValueError("2DTL chunk but no 2D LUT assigned")
            hdr = HeaderTile3D.unpack(body)
            if claims3 is None:   # UpdateTileAndRGBMask split
                claims3 = np.repeat(claims[None], 3, axis=0).copy()
            t2passes += _plan_2d(body[HeaderTile3D.size():], hdr, w, h,
                                 claims3, luts2d_expanded)
        elif tag == b"UCOL":
            uhdr = UniqueColorHeader.unpack(body)
            # same header validation as the host decoder (_ucol_chunk):
            # corrupt bboxes/palette indices raise ValueError, never an
            # internal IndexError from the scatter below
            if (uhdr.x < 0 or uhdr.y < 0 or uhdr.w <= 0 or uhdr.h <= 0
                    or uhdr.x + uhdr.w > w or uhdr.y + uhdr.h > h):
                raise ValueError("UCOL bbox out of image bounds")
            if uhdr.version == 2 and (uhdr.w % 8 or uhdr.h % 8):
                raise ValueError("UCOL swizzled bbox not 8-aligned")
            pal, mp = decode_ucol_map(uhdr, body[UniqueColorHeader.size():])
            n = np.flatnonzero(mp)
            if n.size:
                if int(mp[n].max()) > pal.shape[0]:
                    raise ValueError("UCOL palette index out of range")
                if uhdr.version == 2:
                    tile = n >> 6
                    wu = uhdr.w >> 3
                    xs = ((tile % wu) << 3) | (n & 7)
                    ys = ((tile // wu) << 3) | ((n >> 3) & 7)
                else:
                    xs, ys = n % uhdr.w, n // uhdr.w
                ov = get_overlay()
                ov.vals[uhdr.y + ys, uhdr.x + xs] = pal[mp[n] - 1]
                ov.mask[uhdr.y + ys, uhdr.x + xs] = True
        elif tag == b"SMAP":
            shdr = HeaderSmoothMap.unpack(body)
            seeds = decode_smap_seeds(shdr, body[HeaderSmoothMap.size():],
                                      w, h)
            if len(seeds):
                co = ((seeds[:, 3].astype(np.int64) + 128) % 256) - 128
                cg = ((seeds[:, 4].astype(np.int64) + 128) % 256) - 128
                r, g, b = ycocg_to_rgb(seeds[:, 2].astype(np.int64), co, cg)
                ov = get_overlay()
                ov.vals[seeds[:, 1], seeds[:, 0]] = np.stack(
                    [r & 0xFF, g & 0xFF, b & 0xFF], axis=1).astype(np.uint8)
                ov.mask[seeds[:, 1], seeds[:, 0]] = True
        elif tag == b"PLNT":
            # deprecated research chunk, structure-validated and skipped
            # (as yaik_tpu/decoder/reference.py does)
            ph = PlaneTile.unpack(body)
            pb = body[PlaneTile.size():]
            usize = zstd.frame_content_size(pb[:ph.stream_size_tile_map])
            if usize is None or usize > (ph.w // 8) * (ph.h // 8) * 2:
                raise ValueError("PLNT tile map size out of bounds")
            zstd.decompress(pb[:ph.stream_size_tile_map], usize)
            zstd.decompress(
                pb[ph.stream_size_tile_map:
                   ph.stream_size_tile_map + ph.stream_size_tile_stream],
                ph.expected_size_tile_stream)
        elif tag == b"1DTL":
            hdr = Header1D.unpack(body)
            d1 = _plan_1d(body[Header1D.size():], hdr, w, h,
                          claims if claims3 is None else claims3)
        elif tag == b"MIPM":
            with profiler.stage("plan:mipm"):
                mip_plan = _plan_mipm(body, w, h)
        elif tag == b"ALPM":
            with profiler.stage("plan:alpm"):
                alpha_plan = _plan_alpm(body, w, h, mip_plan)
        else:
            raise NotImplementedError(f"chunk {tag!r} not planned yet")
      except _struct.error as e:
        raise ValueError(f"malformed {tag!r} chunk: {e}") from e

    return DecodePlan(width=w, height=h, gradient=grads, tile3d=t3passes,
                      d1=d1, has_alpha=fh.has_alpha, alpha_plan=alpha_plan,
                      overlay=overlay, tile2d=t2passes or None)


def _plan_mipm(body: bytes, w: int, h: int) -> MipPlan:
    hdr = MipmapHeader.unpack(body)
    ts = 1 << hdr.mipmap_level
    if ts != 16:
        raise NotImplementedError("only 16px mipmap tiles (like the decoder)")
    ntiles = hdr.w * hdr.h
    if hdr.x < 0 or hdr.y < 0 or hdr.w <= 0 or hdr.h <= 0:
        raise ValueError("MIPM bbox invalid")
    if hdr.x * ts + hdr.w * ts > ((w + ts - 1) // ts) * ts or \
       hdr.y * ts + hdr.h * ts > ((h + ts - 1) // ts) * ts:
        raise ValueError("MIPM bbox out of image bounds")
    nbytes = (ntiles + 7) // 8
    data = body[MipmapHeader.size():]
    bits = np.zeros(nbytes, np.uint8)
    avail = min(nbytes, len(data))
    bits[:avail] = np.frombuffer(data, np.uint8, avail)
    return MipPlan(bits=bits, grid=(hdr.w, hdr.h),
                   origin=(hdr.x * ts, hdr.y * ts), level=hdr.mipmap_level)


def _plan_alpm(body: bytes, w: int, h: int,
               mip: MipPlan | None) -> AlphaPlan:
    hdr = AlphaHeader.unpack(body)
    mode = hdr.parameters & 7
    bx, by, bw, bh = hdr.x, hdr.y, hdr.w, hdr.h
    if bw <= 0 or bh <= 0 or bx < 0 or by < 0 or bx + bw > w or by + bh > h:
        raise ValueError("ALPM bbox out of image bounds")
    if mode in (AlphaHeader.IS_6_BIT_USEMIPMAPMASK,
                AlphaHeader.IS_6_BIT_USEMIPMAPMASK_INVERSE) and mip is None:
        raise ValueError("sparse alpha requires a MIPM chunk first")
    if mode == AlphaHeader.IS_1_BIT_FULL:
        needed = (bw * bh + 7) // 8
    elif mode in (AlphaHeader.IS_6_BIT_FULL,
                  AlphaHeader.IS_6_BIT_FULL_INVERSE,
                  AlphaHeader.IS_6_BIT_USEMIPMAPMASK,
                  AlphaHeader.IS_6_BIT_USEMIPMAPMASK_INVERSE):
        # pad to a whole 3-byte group: the 6-bit unpack reads 4 values per
        # 3 bytes (zeros past the stream end, like _unpack6's zero pad)
        needed = (((bw * bh * 6 + 7) // 8 + 2) // 3) * 3
    elif mode == AlphaHeader.IS_8_BIT_FULL:
        needed = bw * bh
    else:
        raise ValueError(f"unsupported alpha mode {mode}")
    payload = zstd.decompress_arr(
        bytes(body[AlphaHeader.size():AlphaHeader.size() + hdr.stream_size]),
        hdr.expected_decompression_size)
    profiler.count("alpm_decoded_bytes", payload.size)
    raw = np.zeros(needed, np.uint8)
    avail = min(needed, payload.size)
    raw[:avail] = payload[:avail]
    return AlphaPlan(
        mode=mode, bbox=(bx, by, bw, bh), raw=raw,
        mip=mip if mode in (AlphaHeader.IS_6_BIT_USEMIPMAPMASK,
                            AlphaHeader.IS_6_BIT_USEMIPMAPMASK_INVERSE)
        else None)


def _plan_3d(body, hdr, w, h, claims, luts_expanded):
    off = 0

    def take(csize, usize):
        nonlocal off
        d = (zstd.decompress_arr(body[off:off + csize], usize) if csize
             else np.empty(0, np.uint8))
        off += csize
        return d

    s = {3: take(hdr.compr_3bit_size, hdr.stream_3bit_cnt),
         4: take(hdr.compr_4bit_size, hdr.stream_4bit_cnt),
         5: take(hdr.compr_5bit_size, hdr.stream_5bit_cnt),
         6: take(hdr.compr_6bit_size, hdr.stream_6bit_cnt)}
    types_b = take(hdr.compr_type_size, hdr.stream_type_cnt * 2)
    colors_b = take(hdr.compr_color_size, hdr.stream_color_cnt)
    maps = {}
    for key, csz, usz in (
            ((4, 3), hdr.size_t16_8_map_cmp, hdr.size_t16_8_map),
            ((3, 4), hdr.size_t8_16_map_cmp, hdr.size_t8_16_map),
            ((3, 3), hdr.size_t8_8_map_cmp, hdr.size_t8_8_map),
            ((3, 2), hdr.size_t8_4_map_cmp, hdr.size_t8_4_map),
            ((2, 3), hdr.size_t4_8_map_cmp, hdr.size_t4_8_map),
            ((2, 2), hdr.size_t4_4_map_cmp, hdr.size_t4_4_map)):
        maps[key] = take(csz, usz)

    colors = palette.full_range_remap(
        colors_b, hdr.compression_rate_color).astype(np.int32).reshape(-1, 6)
    types = types_b.view("<u2")
    use_native = native.available()
    if use_native:
        streams = s
        cursors4 = np.zeros(4, np.int64)
    else:
        max_tiles = sum((w >> sx) * (h >> sy)
                        for (sx, sy) in swizzle.TILE3D_PASS_ORDER)
        streams = {bit: np.concatenate([s[bit], np.zeros(max_tiles, np.uint8)])
                   for bit in (3, 4, 5, 6)}

    def _padded(arr, need, shape1=()):
        """Security padding, grown on demand: corrupted bitmaps may accept
        more tiles than the type/color streams hold - reads past the end
        yield zeros (allocating the worst case up front cost ~1MB/image)."""
        if need <= arr.shape[0]:
            return arr
        pad = np.zeros((need - arr.shape[0],) + shape1, arr.dtype)
        return np.concatenate([arr, pad])

    passes = []
    tcur = 0
    bitcur = {3: 0, 4: 0, 5: 0, 6: 0}

    if use_native:
        # arena allocation: one zeroed buffer per tensor kind for all six
        # passes (the per-pass np.zeros calls were ~0.3ms/image of pure
        # allocator overhead), sliced into per-pass views
        sizes = [(1 << sx, 1 << sy, (w >> sx) * (h >> sy))
                 for (sx, sy) in swizzle.TILE3D_PASS_ORDER]
        G = sum(g for (_, _, g) in sizes)
        PX = sum(g * tw * th for (tw, th, g) in sizes)
        # packed MUST be zeroed: bit 6 is the per-pixel write mask and
        # claimed quads inside accepted tiles are skipped (stay 0). cols is
        # only read for accepted tiles (accept-gated) so it can stay
        # uninitialized.
        packed_all = np.zeros(PX, np.uint8)
        cols_all = np.empty((G, 6), np.int32)
        type_all = np.zeros(G, np.int32)
        accept_all = np.zeros(G, bool)
        claims_u8 = claims.view(np.uint8)
        s4list = [streams[b] for b in (3, 4, 5, 6)]
        bitmaps = []
        for (sx, sy) in swizzle.TILE3D_PASS_ORDER:
            mb = maps[(sx, sy)]
            if len(mb):
                expect = swizzle.bitmap_size_bytes(sx, sy, w, h)
                mb = mb[:expect]
                if mb.size != expect:
                    raise ValueError(f"bitmap size {mb.size} != {expect}")
            bitmaps.append(mb)
        native.plan_3d_all(bitmaps, w, h, types, colors, claims_u8,
                           s4list, cursors4, accept_all.view(np.uint8),
                           type_all, cols_all, packed_all)
        goff = poff = 0
        for pid, (sx, sy) in enumerate(swizzle.TILE3D_PASS_ORDER):
            tw, th, g = sizes[pid]
            ntx, nty = w // tw, h // th
            passes.append(Tile3DPassPlan(
                shift=(sx, sy),
                accept=accept_all[goff:goff + g].reshape(nty, ntx),
                colors=cols_all[goff:goff + g],
                packed=packed_all[poff:poff + g * th * tw].reshape(
                    g, th * tw),
                types=type_all[goff:goff + g]))
            goff += g
            poff += g * th * tw
        return passes

    for pid, (sx, sy) in enumerate(swizzle.TILE3D_PASS_ORDER):
        tw, th = 1 << sx, 1 << sy
        ntx, nty = w // tw, h // th
        g = nty * ntx
        accept = np.zeros((nty, ntx), bool)
        cols = np.zeros((g, 6), np.int32)
        type_arr = np.zeros(g, np.int32)
        indices = np.zeros((g, th * tw), np.uint8)
        wmask = np.zeros((g, th * tw), bool)
        if len(maps[(sx, sy)]):
            bits = swizzle.unpack_bitmap(
                maps[(sx, sy)][:swizzle.bitmap_size_bytes(sx, sy, w, h)],
                sx, sy, w, h)
            tx_all, ty_all, valid = swizzle.tile_scan_coords(sx, sy, w, h)
            pairs = _PAIR_ORDER[(sx, sy)]
            acc = np.flatnonzero(bits & valid)
            n = acc.size
            if n:
                tx, ty = tx_all[acc], ty_all[acc]
                gid = ty * ntx + tx
                qx0, qy0 = tx * (tw // 4), ty * (th // 4)

                types = _padded(types, tcur + n)
                colors = _padded(colors, tcur + n, (6,))
                tid = tcur + np.arange(n)
                ttypes = types[tid].astype(np.int32)
                bit_arr = ((ttypes >> 14) & 3) + 3
                accept[ty, tx] = True
                type_arr[gid] = ttypes
                cols[gid] = colors[tid]

                cases = _group_cases(claims, qx0, qy0, pairs)
                cons_tile = _CASE_BYTES[cases].sum(axis=1)
                base_off = np.zeros(n, np.int64)
                for bit in (3, 4, 5, 6):
                    sel = bit_arr == bit
                    if sel.any():
                        c = cons_tile[sel]
                        ex = np.concatenate([[0], np.cumsum(c[:-1])])
                        base_off[sel] = bitcur[bit] + ex
                        bitcur[bit] += int(c.sum())
                for bit in (3, 4, 5, 6):
                    sel = bit_arr == bit
                    if sel.any():
                        _scatter_streams(
                            cases[sel], pairs, tw, base_off[sel],
                            gid[sel], streams[bit], indices, wmask,
                            premultiplied=True)
                _claim_tiles(claims, qx0, qy0, tw, th)
                tcur += n
        passes.append(Tile3DPassPlan(
            shift=(sx, sy), accept=accept, colors=cols,
            packed=np.minimum(indices, 63) | (wmask.astype(np.uint8) << 6),
            types=type_arr))
    return passes


def _plan_1d(body, hdr, w, h, claims):
    """claims: [QH, QW] shared (gradient/3D only) or [3, QH, QW] per-plane
    (after 2DTL chunks split the masks). With per-plane claims, each plane
    has its own active-tile set, type-triplet count, and pixel-stream span -
    the reference encoder writes R, G, B plane sections back to back
    (Convert :9451-9460)."""
    types = zstd.decompress_arr(body[:hdr.stream_type_cnt],
                                hdr.stream_type_uncmp)
    pix = zstd.decompress_arr(
        body[hdr.stream_type_cnt:hdr.stream_type_cnt + hdr.stream_pixel_bit],
        hdr.stream_pixel_uncmp)
    inv_range = (1 << 24) // hdr.compression_range

    ntx, nty = w // 8, h // 8
    g = nty * ntx
    params = np.zeros((3, g, 3), np.int32)
    indices = np.empty((3, g, 64), np.uint8)   # wmask-gated everywhere
    wmask = np.zeros((3, g, 64), bool)
    per_plane = claims.ndim == 3
    pairs = [[(0, 0), (1, 0)], [(0, 1), (1, 1)]]

    if native.available():
        # consolidated native plane walk: active detection + triplet
        # gather + params + claim-gated pixel scatter in one call per plane
        cl = np.ascontiguousarray(claims).view(np.uint8)
        stride = cl[0].size if per_plane else 0
        native.plan_1d_all(w, h, cl, stride, types, pix, inv_range,
                           params, indices, wmask.view(np.uint8))
        return Plan1D(params=params, indices=indices, wmask=wmask)

    # security padding for corrupt streams (reads past the end yield zeros)
    types = np.concatenate([types, np.zeros(3 * 3 * g + 9, np.uint8)])
    pix = np.concatenate([pix, np.zeros(3 * g * 64, np.uint8)])

    tcur = 0   # type-triplet cursor (bytes)
    pcur = 0   # pixel-stream cursor
    for p in range(3):
        cl = claims[p] if per_plane else claims
        qgrid = cl[:nty * 2, :ntx * 2].reshape(nty, 2, ntx, 2).transpose(
            0, 2, 1, 3)
        active = ~qgrid.all(axis=(2, 3))
        ty, tx = np.nonzero(active)
        n = ty.size
        if n == 0:
            continue
        gid = ty * ntx + tx
        qx0, qy0 = tx * 2, ty * 2

        trip = types[tcur + np.arange(3 * n)].reshape(n, 3)
        tcur += 3 * n
        color0, base, delta = (trip[:, 0].astype(np.int64),
                               trip[:, 1].astype(np.int64),
                               trip[:, 2].astype(np.int64))
        delta2 = ((delta * inv_range) >> 8) + 1
        params[p, gid] = np.stack([color0, base, delta2],
                                  axis=1).astype(np.int32)
        cases = _group_cases(cl, qx0, qy0, pairs)
        cons_tile = _CASE_BYTES[cases].sum(axis=1)
        ex = np.concatenate([[0], np.cumsum(cons_tile[:-1])])
        _scatter_streams(cases, pairs, 8, pcur + ex, gid,
                         pix, indices[p], wmask[p], premultiplied=False)
        pcur += int(cons_tile.sum())
    return Plan1D(params=params, indices=indices, wmask=wmask)


def _plan_2d(body, hdr, w, h, claims3, luts2d_expanded):
    """One 2DTL chunk -> [Tile2DPassPlan (3,3), Tile2DPassPlan (2,2)].
    Mirrors decoder/reference._tile2d_chunk: 4-byte colors, x2-premultiplied
    indices, claims read as the pair union and written to both pair planes."""
    if hdr.component not in _PAIR2D:
        raise ValueError("invalid 2DTL component")
    pa, pb = _PAIR2D[hdr.component]
    mode = {3: 0, 6: 1, 5: 2}[hdr.component]
    off = 0

    def take(csize, usize):
        nonlocal off
        d = (zstd.decompress_arr(body[off:off + csize], usize) if csize
             else np.empty(0, np.uint8))
        off += csize
        return d

    s = {3: take(hdr.compr_3bit_size, hdr.stream_3bit_cnt),
         4: take(hdr.compr_4bit_size, hdr.stream_4bit_cnt),
         5: take(hdr.compr_5bit_size, hdr.stream_5bit_cnt),
         6: take(hdr.compr_6bit_size, hdr.stream_6bit_cnt)}
    types_b = take(hdr.compr_type_size, hdr.stream_type_cnt * 2)
    colors_b = take(hdr.compr_color_size, hdr.stream_color_cnt)
    m8_8 = take(hdr.size_t8_8_map_cmp, hdr.size_t8_8_map)
    m4_4 = take(hdr.size_t4_4_map_cmp, hdr.size_t4_4_map)
    maps = {(3, 3): m8_8, (2, 2): m4_4}

    colors = palette.full_range_remap(
        colors_b, hdr.compression_rate_color).astype(np.int32).reshape(-1, 4)
    types = types_b.view("<u2")
    max_tiles = (w >> 3) * (h >> 3) + (w >> 2) * (h >> 2)
    types = np.concatenate([types, np.zeros(max_tiles, "<u2")])
    colors = np.concatenate([colors, np.zeros((max_tiles, 4), np.int32)])
    streams = {bit: np.concatenate([s[bit], np.zeros(w * h, np.uint8)])
               for bit in (3, 4, 5, 6)}

    n2_tables = luts2d_expanded[3].shape[0]
    union = claims3[pa] | claims3[pb]

    passes = []
    tcur = 0
    bitcur = {3: 0, 4: 0, 5: 0, 6: 0}
    for (sx, sy) in ((3, 3), (2, 2)):
        tw, th = 1 << sx, 1 << sy
        ntx, nty = w // tw, h // th
        g = nty * ntx
        accept = np.zeros((nty, ntx), bool)
        type_arr = np.zeros(g, np.int32)
        cols = np.zeros((g, 4), np.int32)
        idx_arr = np.zeros((g, th * tw), np.uint8)
        wm = np.zeros((g, th * tw), bool)
        if len(maps[(sx, sy)]):
            bits = swizzle.unpack_bitmap(
                maps[(sx, sy)][:swizzle.bitmap_size_bytes(sx, sy, w, h)],
                sx, sy, w, h)
            tx_all, ty_all, valid = swizzle.tile_scan_coords(sx, sy, w, h)
            pairs = _PAIR_ORDER[(sx, sy)]
            acc = np.flatnonzero(bits & valid)
            n = acc.size
            if n:
                tx, ty = tx_all[acc], ty_all[acc]
                gid = ty * ntx + tx
                qx0, qy0 = tx * (tw // 4), ty * (th // 4)

                tid = tcur + np.arange(n)
                ttypes = types[tid].astype(np.int32)
                bit_arr = ((ttypes >> 14) & 3) + 3
                accept[ty, tx] = True
                type_arr[gid] = ttypes
                cols[gid] = colors[tid]

                cases = _group_cases(union, qx0, qy0, pairs)
                cons_tile = _CASE_BYTES[cases].sum(axis=1)
                base_off = np.zeros(n, np.int64)
                for bit in (3, 4, 5, 6):
                    selb = bit_arr == bit
                    if selb.any():
                        c = cons_tile[selb]
                        ex = np.concatenate([[0], np.cumsum(c[:-1])])
                        base_off[selb] = bitcur[bit] + ex
                        bitcur[bit] += int(c.sum())
                for bit in (3, 4, 5, 6):
                    selb = bit_arr == bit
                    if selb.any():
                        _scatter_streams(
                            cases[selb], pairs, tw, base_off[selb],
                            gid[selb], streams[bit] // 2, idx_arr, wm,
                            premultiplied=False)
                _claim_tiles(claims3[pa], qx0, qy0, tw, th)
                _claim_tiles(claims3[pb], qx0, qy0, tw, th)
                _claim_tiles(union, qx0, qy0, tw, th)
                tcur += n
        passes.append(Tile2DPassPlan(mode=mode, shift=(sx, sy), accept=accept,
                                     types=type_arr, colors=cols,
                                     packed=(np.minimum(idx_arr, 63)
                                             | (wm.astype(np.uint8) << 6))))
    return passes
