"""The plain reference decoder: a frozen copy of the port's numpy host
decoder (`decoder/reference.py`, the port's `engine="host"`, itself a
direct port of the reference decoder's YAIK_API.cpp chunk loop,
YAIK_Gradient.cpp and YAIK_3DTile.cpp), holding the chunks a default
RGB or RGBA encode writes: GTIL, 3DTL / 3DTX and 1DTL, and the alpha
chunks MIPM and ALPM (`reference.alpha`). 2DTL, SMAP, UCOL and PLNT, which
only passes the reference leaves disabled write, are refused. It shares no
code with the card's kernels or the port's planner.

Planes are stored de-swizzled as [H8, W8] u8 (H8/W8 = image rounded up to 8);
the reference's 8x8-tile swizzle is a storage order only - all writes are
tile-aligned rectangles, so pixel values are identical.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.reference import alpha as alphamod
from portbench.reference import palette, zstd
from portbench.reference import lut as lutmod
from portbench.reference import swizzle
from portbench.reference.headers import (END_TAG, Header1D, HeaderBase,
                                     HeaderGradientTile, HeaderTile3D,
                                     HeaderTile3DX, FileHeader, MAGIC)

# quad-pair decode order per 3D tile size (shift_x, shift_y) -> list of
# "columns pairs": each element is a list of quad (qx, qy) processed together
# (2 = left/right pair with interleaved rows, 1 = single quad).
_PAIR_ORDER = {
    (4, 3): [[(0, 0), (1, 0)], [(0, 1), (1, 1)], [(2, 0), (3, 0)], [(2, 1), (3, 1)]],
    (3, 4): [[(0, 0), (1, 0)], [(0, 1), (1, 1)], [(0, 2), (1, 2)], [(0, 3), (1, 3)]],
    (3, 3): [[(0, 0), (1, 0)], [(0, 1), (1, 1)]],
    (3, 2): [[(0, 0), (1, 0)]],
    (2, 3): [[(0, 0)], [(0, 1)]],
    (2, 2): [[(0, 0)]],
}


@dataclass
class DecodeState:
    width: int
    height: int
    has_alpha: bool
    planes: np.ndarray        # [3, H8, W8] u8
    alpha: np.ndarray | None  # [H, W] u8 or None
    map_rgb: np.ndarray       # [nq, 3] u8 corner colors at quarter res
    has_rgb: np.ndarray       # [3, nq] bool per-plane corner-seen mask
    claims: np.ndarray        # [3, QH, QW] bool per-plane 4x4-quad claims
    single_rgb: bool = True   # masks still shared across planes
    stride_q: int = 0         # strideRGBMap = w//4 + 1

    @classmethod
    def create(cls, w: int, h: int, has_alpha: bool):
        h8, w8 = ((h + 7) // 8) * 8, ((w + 7) // 8) * 8
        stride_q = w // 4 + 1
        nq = stride_q * (h // 4 + 1)
        qh, qw = swizzle.claim_shape(w, h)
        return cls(
            width=w, height=h, has_alpha=has_alpha,
            planes=np.full((3, h8, w8), 0x80, np.uint8),
            alpha=None,
            map_rgb=np.zeros((nq, 3), np.uint8),
            has_rgb=np.zeros((3, nq), bool),
            claims=np.zeros((3, qh, qw), bool),
            stride_q=stride_q,
        )

    def split_masks(self):
        """UpdateTileAndRGBMask (YAIK_API.cpp:530-544): duplicate shared
        masks to per-plane masks on first non-RGB-combined work."""
        if self.single_rgb:
            self.single_rgb = False
            self.has_rgb[1] = self.has_rgb[0]
            self.has_rgb[2] = self.has_rgb[0]
            self.claims[1] = self.claims[0]
            self.claims[2] = self.claims[0]


def _bilinear_tile(c00, c01, c10, c11, tw: int, th: int) -> np.ndarray:
    """Exact integer bilinear fill (YAIK_Gradient.cpp blend math):
    out[ty,tx] = ((c00*(TH-ty)+c10*ty)*(TW-tx) + (c01*(TH-ty)+c11*ty)*tx)
                 >> (log2 TH + log2 TW).  Inputs are int vectors [3]."""
    ty = np.arange(th, dtype=np.int32)[:, None, None]
    tx = np.arange(tw, dtype=np.int32)[None, :, None]
    left = c00[None, None, :] * (th - ty) + c10[None, None, :] * ty
    right = c01[None, None, :] * (th - ty) + c11[None, None, :] * ty
    shift = (th.bit_length() - 1) + (tw.bit_length() - 1)
    return ((left * (tw - tx) + right * tx) >> shift).astype(np.uint8)


def _gradient_chunk(st: DecodeState, hdr: HeaderGradientTile, body: bytes):
    """Decode one GTIL chunk (all tile sizes / plane combos)."""
    w, h = st.width, st.height
    sx, sy = hdr.shift_x, hdr.shift_y
    tw, th = 1 << sx, 1 << sy

    bitmap = zstd.decompress(body[:hdr.stream_bitmap_size],
                             swizzle.bitmap_size_bytes(sx, sy, w, h))
    rgb_cust = zstd.decompress(
        body[hdr.stream_bitmap_size:hdr.stream_bitmap_size + hdr.stream_rgb_size_zstd],
        hdr.stream_rgb_size_custom)
    rgb = palette.palette_decompress(rgb_cust, hdr.stream_rgb_size_uncompressed,
                                     hdr.color_compression)
    # security offset like the reference (YAIK_API.cpp:896-910): corrupted
    # bitmaps may claim more corners than the stream holds; over-allocate
    # so reads return zeros instead of faulting
    rgb = np.concatenate(
        [rgb, np.zeros(3 * ((w // 4 + 1) * (h // 4 + 1)), np.uint8)])

    if hdr.plane != 7:
        st.split_masks()
    planes = [p for p in range(3) if hdr.plane & (1 << p)]

    tx_all, ty_all, valid = swizzle.tile_scan_coords(sx, sy, w, h)
    bits = swizzle.unpack_bitmap(bitmap, sx, sy, w, h)
    sel = np.flatnonzero(bits & valid)

    cursor = 0
    sq = st.stride_q
    for i in sel:
        tx, ty = int(tx_all[i]), int(ty_all[i])
        qx, qy = tx * (tw // 4), ty * (th // 4)
        base = qy * sq + qx
        ids = (base, base + tw // 4,
               base + (th // 4) * sq, base + (th // 4) * sq + tw // 4)
        # corner consumption order: LT, RT, LB, RB
        if hdr.plane == 7:
            # the plane-7 decoders always use the plane-0 masks
            # (YAIK_Gradient.cpp: hasRGB = pInstance->mapRGBMask)
            for cid in ids:
                if not st.has_rgb[0][cid]:
                    st.has_rgb[0][cid] = True
                    st.map_rgb[cid] = rgb[cursor:cursor + 3]
                    cursor += 3
        else:
            for cid in ids:
                for p in planes:
                    if not st.has_rgb[p][cid]:
                        st.has_rgb[p][cid] = True
                        st.map_rgb[cid, p] = rgb[cursor]
                        cursor += 1
        c = st.map_rgb[list(ids)].astype(np.int32)  # [4, 3] LT RT LB RB
        tile = _bilinear_tile(c[0], c[1], c[2], c[3], tw, th)
        x, y = tx * tw, ty * th
        if hdr.plane == 7:
            st.planes[:, y:y + th, x:x + tw] = tile.transpose(2, 0, 1)
            st.claims[0][qy:qy + th // 4, qx:qx + tw // 4] = True
        else:
            for p in planes:
                st.planes[p, y:y + th, x:x + tw] = tile[:, :, p]
                st.claims[p][qy:qy + th // 4, qx:qx + tw // 4] = True


def _tile3d_size_pass(st: DecodeState, sx: int, sy: int, bitmap: bytes,
                      cursors: dict, colors: np.ndarray, types: np.ndarray,
                      idx_streams: dict, luts: dict):
    w, h = st.width, st.height
    tw, th = 1 << sx, 1 << sy
    tx_all, ty_all, valid = swizzle.tile_scan_coords(sx, sy, w, h)
    # 3D tile maps are allocated bits-as-bytes (8x padded) by the encoder
    # (BitmapSwizzleMapSize, EncoderContext.cpp:7310-7314 - no /8); only the
    # leading true-bitmap bytes carry data.
    bits = swizzle.unpack_bitmap(
        bitmap[:swizzle.bitmap_size_bytes(sx, sy, w, h)], sx, sy, w, h)
    sel = np.flatnonzero(bits & valid)
    pairs = _PAIR_ORDER[(sx, sy)]
    claims = st.claims[0]  # 3D pass operates on the combined RGB claim map

    for i in sel:
        tx, ty = int(tx_all[i]), int(ty_all[i])
        x, y = tx * tw, ty * th
        rgb = colors[cursors["color"]:cursors["color"] + 6].astype(np.int32)
        cursors["color"] += 6
        tile_type = int(types[cursors["type"]])
        cursors["type"] += 1
        combined = tile_type & 0x3FFF
        fmt = (tile_type >> 14) & 3      # 0..3 -> 3..6 bit
        bit = fmt + 3
        lut = luts[bit]                  # [tables*64, 2**bit * 3] flat i32
        # guard like the reference's over-allocated LUT space
        # (YAIK_API.cpp:252-256): out-of-range table/entry reads are garbage
        # there, clamped here - corrupt streams yield garbage pixels, not OOB
        combined = min(combined, lut.shape[0] - 1)
        diff = rgb[3:6] - rgb[0:3]

        stream = idx_streams[bit]
        cur = cursors[bit]
        qx0, qy0 = x // 4, y // 4

        for group in pairs:
            if len(group) == 2:
                (gx0, gy0), (gx1, _) = group
                b0 = claims[qy0 + gy0, qx0 + gx0]
                b1 = claims[qy0 + gy0, qx0 + gx1]
                px, py = x + gx0 * 4, y + gy0 * 4
                if not b0 and not b1:
                    idxs = np.minimum(stream[cur:cur + 32].astype(np.int64), lut.shape[1] - 3); cur += 32
                    vals = lut[combined, idxs[:, None] + np.arange(3)]
                    out = ((rgb[None, 0:3] + ((diff[None, :] * vals) >> 7))
                           & 0xFF).astype(np.uint8)
                    st.planes[:, py:py + 4, px:px + 8] = (
                        out.reshape(4, 8, 3).transpose(2, 0, 1))
                elif not b0:
                    idxs = np.minimum(stream[cur:cur + 16].astype(np.int64), lut.shape[1] - 3); cur += 16
                    vals = lut[combined, idxs[:, None] + np.arange(3)]
                    out = ((rgb[None, 0:3] + ((diff[None, :] * vals) >> 7))
                           & 0xFF).astype(np.uint8)
                    st.planes[:, py:py + 4, px:px + 4] = (
                        out.reshape(4, 4, 3).transpose(2, 0, 1))
                elif not b1:
                    idxs = np.minimum(stream[cur:cur + 16].astype(np.int64), lut.shape[1] - 3); cur += 16
                    vals = lut[combined, idxs[:, None] + np.arange(3)]
                    out = ((rgb[None, 0:3] + ((diff[None, :] * vals) >> 7))
                           & 0xFF).astype(np.uint8)
                    st.planes[:, py:py + 4, px + 4:px + 8] = (
                        out.reshape(4, 4, 3).transpose(2, 0, 1))
            else:
                (gx0, gy0), = group
                px, py = x + gx0 * 4, y + gy0 * 4
                if not claims[qy0 + gy0, qx0 + gx0]:
                    idxs = np.minimum(stream[cur:cur + 16].astype(np.int64), lut.shape[1] - 3); cur += 16
                    vals = lut[combined, idxs[:, None] + np.arange(3)]
                    out = ((rgb[None, 0:3] + ((diff[None, :] * vals) >> 7))
                           & 0xFF).astype(np.uint8)
                    st.planes[:, py:py + 4, px:px + 4] = (
                        out.reshape(4, 4, 3).transpose(2, 0, 1))
        cursors[bit] = cur
        # claim the full tile rect (all variants end up claiming their area)
        claims[qy0:qy0 + th // 4, qx0:qx0 + tw // 4] = True


def _tile3d_chunk(st: DecodeState, hdr: HeaderTile3D, body: bytes,
                  luts_expanded: dict):
    off = 0

    def take(csize: int, usize: int):
        nonlocal off
        d = zstd.decompress(body[off:off + csize], usize) if csize else b""
        off += csize
        return d

    s3 = take(hdr.compr_3bit_size, hdr.stream_3bit_cnt)
    s4 = take(hdr.compr_4bit_size, hdr.stream_4bit_cnt)
    s5 = take(hdr.compr_5bit_size, hdr.stream_5bit_cnt)
    s6 = take(hdr.compr_6bit_size, hdr.stream_6bit_cnt)
    types_b = take(hdr.compr_type_size, hdr.stream_type_cnt * 2)
    colors_b = take(hdr.compr_color_size, hdr.stream_color_cnt)
    m16_8 = take(hdr.size_t16_8_map_cmp, hdr.size_t16_8_map)
    m8_16 = take(hdr.size_t8_16_map_cmp, hdr.size_t8_16_map)
    m8_8 = take(hdr.size_t8_8_map_cmp, hdr.size_t8_8_map)
    m8_4 = take(hdr.size_t8_4_map_cmp, hdr.size_t8_4_map)
    m4_8 = take(hdr.size_t4_8_map_cmp, hdr.size_t4_8_map)
    m4_4 = take(hdr.size_t4_4_map_cmp, hdr.size_t4_4_map)

    colors = palette.full_range_remap(np.frombuffer(colors_b, np.uint8),
                                      hdr.compression_rate_color)
    types = np.frombuffer(types_b, "<u2")
    idx_streams = {3: np.frombuffer(s3, np.uint8),
                   4: np.frombuffer(s4, np.uint8),
                   5: np.frombuffer(s5, np.uint8),
                   6: np.frombuffer(s6, np.uint8)}
    # flatten LUTs: [tables*64, 2**bit * 3] so premultiplied-by-3 stream
    # indices address them directly (encoder premultiply EncoderContext.cpp:
    # 7520-7531, decoder use YAIK_3DTile.cpp:1071-1076)
    luts = {bit: arr.reshape(arr.shape[0], -1)
            for bit, arr in luts_expanded.items()}

    # popcount cross-validation (CheckTileCount, YAIK_API.cpp:628-641):
    # cumulative accepted-tile count must stay within the type stream
    cursors = {"color": 0, "type": 0, 3: 0, 4: 0, 5: 0, 6: 0}
    maps = {(4, 3): m16_8, (3, 4): m8_16, (3, 3): m8_8,
            (3, 2): m8_4, (2, 3): m4_8, (2, 2): m4_4}
    # over-allocate streams so within-tile overruns on corrupt claims read
    # zeros (the reference's security-offset model)
    total_px = st.planes.shape[1] * st.planes.shape[2]
    colors = np.concatenate([colors, np.zeros(total_px * 6, np.uint8)])
    idx_streams = {b: np.concatenate([s, np.zeros(total_px, np.uint8)])
                   for b, s in idx_streams.items()}
    security_count = 0
    for (sx, sy) in swizzle.TILE3D_PASS_ORDER:
        if maps[(sx, sy)]:
            bm = swizzle.unpack_bitmap(
                maps[(sx, sy)][:swizzle.bitmap_size_bytes(
                    sx, sy, st.width, st.height)], sx, sy, st.width, st.height)
            security_count += int(bm.sum())
            if security_count > hdr.stream_type_cnt:
                continue
            _tile3d_size_pass(st, sx, sy, maps[(sx, sy)], cursors,
                              colors, types, idx_streams, luts)


def _tile1d_chunk(st: DecodeState, hdr: Header1D, body: bytes):
    types = np.frombuffer(
        zstd.decompress(body[:hdr.stream_type_cnt], hdr.stream_type_uncmp),
        np.uint8)
    pix = np.frombuffer(
        zstd.decompress(body[hdr.stream_type_cnt:
                             hdr.stream_type_cnt + hdr.stream_pixel_bit],
                        hdr.stream_pixel_uncmp), np.uint8)
    st.split_masks()
    # over-allocate so corrupt claim patterns read zeros, not OOB
    total_tiles = (st.planes.shape[1] // 8) * (st.planes.shape[2] // 8)
    types = np.concatenate([types, np.zeros(total_tiles * 9, np.uint8)])
    pix = np.concatenate([pix, np.zeros(total_tiles * 64 * 3, np.uint8)])
    if hdr.compression_range == 0:
        raise ValueError("invalid 1D compression range")
    inv_range = (1 << 24) // hdr.compression_range
    tcur = 0
    pcur = 0
    w, h = st.width, st.height
    for p in range(3):
        claims = st.claims[p]
        plane = st.planes[p]
        for y in range(0, h, 8):
            for x in range(0, w, 8):
                qx0, qy0 = x // 4, y // 4
                quad = claims[qy0:qy0 + 2, qx0:qx0 + 2]
                if quad.all():
                    continue
                color0 = int(types[tcur]); base = int(types[tcur + 1])
                delta = int(types[tcur + 2]); tcur += 3
                delta2 = ((delta * inv_range) >> 8) + 1
                for gy in range(2):
                    b0 = bool(quad[gy, 0]); b1 = bool(quad[gy, 1])
                    py = y + gy * 4
                    if not b0 and not b1:
                        ls = pix[pcur:pcur + 32].astype(np.int64); pcur += 32
                        vals = np.where(ls != 0,
                                        (base + (((ls - 1) * delta2) >> 16)),
                                        color0).astype(np.uint8)
                        plane[py:py + 4, x:x + 8] = vals.reshape(4, 8)
                    elif not b0:
                        ls = pix[pcur:pcur + 16].astype(np.int64); pcur += 16
                        vals = np.where(ls != 0,
                                        (base + (((ls - 1) * delta2) >> 16)),
                                        color0).astype(np.uint8)
                        plane[py:py + 4, x:x + 4] = vals.reshape(4, 4)
                    elif not b1:
                        ls = pix[pcur:pcur + 16].astype(np.int64); pcur += 16
                        vals = np.where(ls != 0,
                                        (base + (((ls - 1) * delta2) >> 16)),
                                        color0).astype(np.uint8)
                        plane[py:py + 4, x + 4:x + 8] = vals.reshape(4, 4)


def iter_chunks(stream: bytes):
    """Yield (tag, header_offset, body) for each chunk; validates bounds."""
    off = FileHeader.size()
    n = len(stream)
    while True:
        if off + 4 > n:
            raise ValueError("stream ended without 0xDEADBEEF")
        tag32 = int.from_bytes(stream[off:off + 4], "little")
        if tag32 == END_TAG:
            return
        hb = HeaderBase.unpack(stream, off)
        body_start = off + HeaderBase.size()
        body_end = body_start + hb.length
        if body_end > n:
            raise ValueError("chunk exceeds stream bounds")
        yield hb.tag, body_start, stream[body_start:body_end]
        off = body_end


def decode(stream: bytes, lut_data: bytes | dict) -> np.ndarray:
    """Decode a .yaik stream of GTIL, 3DTL, 3DTX, 1DTL, MIPM and ALPM
    chunks. Returns [h, w, 3] u8, or [h, w, 4] where the file header sets
    has_alpha (alpha 255 where the stream holds no ALPM). lut_data: raw
    LutFile.lut bytes or an already-expanded LUT dict."""
    if len(stream) <= FileHeader.size():
        raise ValueError("stream too small")  # YAIK_INVALID_STREAM
    fh = FileHeader.unpack(stream)
    if fh.tag != MAGIC:
        raise ValueError("not a YAIK stream")
    st = DecodeState.create(fh.width, fh.height, fh.has_alpha)
    if isinstance(lut_data, dict):
        luts_expanded = lut_data
    else:
        luts_expanded = lutmod.expand_lut(lutmod.parse_lut_file(lut_data))

    import struct as _struct
    mip_mask = None
    def _chunks_checked(s):
        try:
            yield from iter_chunks(s)
        except _struct.error as e:
            raise ValueError(f"malformed chunk: {e}") from e
    for tag, off, body in _chunks_checked(stream):
        try:
            if tag == b"GTIL":
                hdr = HeaderGradientTile.unpack(body)
                _gradient_chunk(st, hdr, body[HeaderGradientTile.size():])
            elif tag in (b"3DTL", b"3DTX"):
                cls = HeaderTile3D if tag == b"3DTL" else HeaderTile3DX
                hdr = cls.unpack(body)
                _tile3d_chunk(st, hdr, body[cls.size():], luts_expanded)
            elif tag == b"1DTL":
                hdr = Header1D.unpack(body)
                _tile1d_chunk(st, hdr, body[Header1D.size():])
            elif tag == b"MIPM":
                mip_mask = alphamod.decode_mipm(body, fh.width, fh.height)
            elif tag == b"ALPM":
                st.alpha = alphamod.decode_alpm(body, fh.width, fh.height,
                                                mip_mask)
            elif tag in (b"2DTL", b"SMAP", b"UCOL", b"PLNT"):
                raise ValueError(f"{tag!r}: a chunk this frozen copy does "
                                 "not decode (no configuration's streams "
                                 "hold one)")
            else:
                raise ValueError(f"unknown chunk tag {tag!r}")
        except _struct.error as e:
            raise ValueError(f"malformed {tag!r} chunk: {e}") from e

    out = st.planes[:, :fh.height, :fh.width].transpose(1, 2, 0)
    if st.has_alpha:
        if st.alpha is None:
            # hasAlpha stream without an ALPM chunk (all-0/all-1 alpha is
            # dropped by the encoder); default opaque
            st.alpha = np.full((fh.height, fh.width), 255, np.uint8)
        out = np.concatenate([out, st.alpha[:, :, None]], axis=2)
    return np.ascontiguousarray(out)
