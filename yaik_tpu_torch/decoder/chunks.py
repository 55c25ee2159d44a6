"""What the decode planner reads of the host reference decoder: the chunk
walk, the quad-pair orders and the UCOL/SMAP chunk replays.

The port's copy of those parts of `yaik_tpu/decoder/reference.py`
(`_PAIR_ORDER`, `_PAIR2D`, `iter_chunks`, `decode_ucol_map`,
`decode_smap_seeds`).
"""
from __future__ import annotations

import numpy as np

from yaik_tpu_torch.entropy import zstd_backend as zstd
from yaik_tpu_torch.format.headers import END_TAG, FileHeader, HeaderBase

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

# 2DTL component -> its plane pair (RG, GB, RB)
_PAIR2D = {3: (0, 1), 6: (1, 2), 5: (0, 2)}


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


def decode_ucol_map(hdr, body: bytes):
    """Reconstruct the UCOL palette-index map: palette [n, 3] u8 plus the
    replayed span stream as a [bh*bw] u8 map (indices in swizzle space when
    hdr.version == 2). The encoder's verifyComp (EncoderContext.cpp:1749)
    documents the replay: pos += deltaStart; copy length bytes."""
    n_colors = hdr.color_count - 1 if hdr.color_count else 255
    off = 0
    palette = np.frombuffer(body, np.uint8, n_colors * 3, off).reshape(-1, 3)
    off += n_colors * 3
    z_map = body[off:off + hdr.stream_size]
    off += hdr.stream_size
    z_spans = body[off:off + hdr.stream_size_e]
    stream = zstd.decompress_arr(z_map, hdr.expected_decompression_size)
    spans = np.frombuffer(
        zstd.decompress(z_spans, hdr.expected_decompression_skippers),
        "<u4").reshape(-1, 2)
    map_size = hdr.w * hdr.h
    map_pixel = np.zeros(map_size, np.uint8)
    pos = 0
    cur = 0
    for delta, length in spans:
        pos += int(delta)
        if pos + int(length) > map_size or cur + int(length) > stream.size:
            raise ValueError("UCOL span exceeds map bounds")
        map_pixel[pos:pos + length] = stream[cur:cur + length]
        cur += int(length)
    return palette, map_pixel


def decode_smap_seeds(hdr, body: bytes, w: int, h: int):
    """Reconstruct the SMAP seed list: replay the encoder's 1/16-res
    enumeration (yaik_tpu/encoder/smooth_map.py) over the 1-bit half-res
    map, including the clamped reads and the in-buffer 128-marker
    evolution. Returns [n, 5] i32 (x, y, Y, Co, Cg)."""
    qh, qw = h // 2, w // 2
    n_bits = hdr.w * hdr.h
    raw = zstd.decompress_arr(body[:hdr.stream_size], (n_bits + 7) >> 3) \
        if hdr.stream_size else np.zeros(0, np.uint8)
    rgb = zstd.decompress_arr(
        body[hdr.stream_size:hdr.stream_size + hdr.rgb_stream_size],
        hdr.expected_rgb_stream_size) if hdr.rgb_stream_size else \
        np.zeros(0, np.uint8)

    q = np.zeros(qh * qw, np.int32)
    if n_bits:
        bits = np.unpackbits(raw, bitorder="little")[:n_bits]
        ys, xs = np.mgrid[hdr.y:hdr.y + hdr.h, hdr.x:hdr.x + hdr.w]
        idx = (xs + ys * qw).reshape(-1)
        ok = idx < q.size
        q[idx[ok]] = bits[ok] * 255

    q2 = q.reshape(qh, qw)
    seeds = []
    cur = 0
    for y in range(0, h, 4):
        for x in range(0, w, 4):
            cx, cy = min(x, qw - 1), min(y, qh - 1)
            if q2[cy, cx]:
                if x + y * qw < qw * qh:
                    q[x + y * qw] = 128
                if cur + 3 <= rgb.size:
                    seeds.append((x, y, int(rgb[cur]), int(rgb[cur + 1]),
                                  int(rgb[cur + 2])))
                cur += 3
    return np.asarray(seeds, np.int32).reshape(-1, 5)

