"""The encoder's host side of chunk emission: a frozen copy of what the
plain encoder uses of the port's `encoder/context.py` (the reference's
EncoderContext::Convert, EncoderContext.cpp:8986-9787): the configuration,
chunk framing, the deferred zstd batch and the functions that make the
GTIL and 3DTL chunks.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.reference import zstd
from portbench.reference import swizzle
from portbench.reference.headers import (HeaderBase, HeaderGradientTile,
                                           HeaderTile3D, HeaderTile3DX)


@dataclass
class EncoderConfig:
    """Knobs mirroring the reference CLI defaults (ImageEncoder.cpp:175-190,
    EncoderContext.h:221-233)."""
    reject_factor: int = 3
    color_compression_quad: int = 250
    color_compression_lut3d: int = 250
    color_compression_1d: int = 255
    range_compression_1d: int = 15
    # alpha/mipmap passes (decoder-supported; disabled in the reference's
    # Convert at EncoderContext.cpp:9027-9028 but fully implemented there)
    enable_mipmap: bool = True
    enable_alpha: bool = True
    alpha_force_8bit: bool = True     # Convert's ProcessAlpha(true)
    alpha_use_inverse: bool = True
    # SingleColorOut (UCOL): disabled in the reference's Convert at
    # EncoderContext.cpp:9036; implemented in encoder/single_color.py
    enable_single_color: bool = False
    favor_accuracy: bool = False      # EncoderContext.h:262, CLI sets false
    # Correlation2DSearch (2DTL chunks, RG/GB/RB): inside `#if 0` in the
    # reference's Convert (:9300-9382); needs a Bank2D (encoder/bank2d.py)
    enable_2d: bool = False
    # SmoothMap (SMAP): dead code upstream (no call site; the pass as
    # written aborts on heap corruption: encoder/smooth_map.py)
    enable_smooth_map: bool = False
    # DynamicTileEncode (PLNT, YCoCg range-coded tiles): disabled in the
    # reference's Convert (`#if 0` :9539-9545); see encoder/plnt.py
    enable_plnt: bool = False
    # plane-subset gradient passes (GTIL with plane != 7): the disabled
    # 2-plane 4x4 calls (`if (0)` :9260-9290, RB/RG/GB order) and 1-plane
    # 4x4 calls (`#if 0` :9392-9420, R/G/B) - singles run AFTER the 2D
    # block in Convert's layout
    enable_plane_gradients: bool = False


def _chunk(tag: bytes, body: bytes) -> bytes:
    length = (len(body) + 3) & ~3
    return HeaderBase(tag, length).pack() + body + b"\0" * (length - len(body))


def _compress_job(job: tuple) -> bytes:
    data, level, cap = job
    return zstd.compress(data, level, cap)


class _ZstdBatch:
    """Deferred zstd-18 compression for one image's chunk streams: emission
    queues raw streams, `run` compresses them in order on the calling
    thread, and each chunk's closure reads its results with `get`."""
    __slots__ = ("jobs", "results")

    def __init__(self):
        self.jobs: list = []
        self.results: list | None = None

    def add(self, data, level: int = 18, cap: int | None = None) -> int:
        if cap is None:
            cap = max(len(data) * 2, 1000)
        self.jobs.append((bytes(data), level, cap))
        return len(self.jobs) - 1

    def run(self) -> None:
        self.results = [_compress_job(j) for j in self.jobs]

    def get(self, h: int) -> bytes:
        return self.results[h]


def _gtil_deferred(zb, bitmap, cust, raw_len, color_compression, sx, sy,
                   plane, w, h, bbox=None):
    """Queue one GTIL chunk's two zstd streams on the batch; returns the
    assembly closure (exact bytes of the old inline path). bbox: already
    computed by the native emission pass, else derived from the bitmap."""
    hb = zb.add(bitmap)
    hr = zb.add(cust)
    if bbox is None:
        bbox = _gradient_bbox(bitmap, sx, sy, w, h)
    cust_len = len(cust)

    def mk():
        z_bitmap, z_rgb = zb.get(hb), zb.get(hr)
        hdr = HeaderGradientTile(
            x=bbox[0], y=bbox[1], w=bbox[2], h=bbox[3],
            stream_bitmap_size=len(z_bitmap),
            stream_rgb_size_zstd=len(z_rgb),
            stream_rgb_size_custom=cust_len,
            stream_rgb_size_uncompressed=raw_len,
            color_compression=color_compression,
            version=0, format=sx | (sy << 3), plane=plane)
        return _chunk(b"GTIL", hdr.pack() + z_bitmap + z_rgb)
    return mk


def _gradient_bbox(bitmap: bytes, sx: int, sy: int, w: int, h: int):
    """The reference's GTIL bbox, including its h = maxY - minX bug
    (EncoderContext.cpp:4252: header.bbox.h = maxY - minX)."""
    tw, th = 1 << sx, 1 << sy
    grid, _ = swizzle.accept_grid(bitmap, sx, sy, w, h)
    ty, tx = np.nonzero(grid)
    min_x, max_x = int(tx.min()) * tw, (int(tx.max()) + 1) * tw
    min_y, max_y = int(ty.min()) * th, (int(ty.max()) + 1) * th
    return min_x, min_y, max_x - min_x, max_y - min_x


def _tile3d_chunk_deferred(streams, cfg, w, h, zb):
    """EndCorrelationSearch (:7366-7660): posterize colors, premultiply
    indices by 3, zstd everything, emit the 3DTL chunk. Raw streams queue
    on the zstd batch; the closure assembles after the batch runs."""
    # each map buffer is bits-as-bytes sized (the reference's 8x
    # over-allocation, BitmapSwizzleMapSize :7310); only the leading
    # true-bitmap bytes carry data, the rest compress to nothing.
    def qmap(key):
        raw = streams["maps"][key].astype(np.uint8).tobytes()
        return len(raw), zb.add(raw, 18, len(raw) * 2)

    n_t16_8, h_t16_8 = qmap((4, 3))
    n_t8_16, h_t8_16 = qmap((3, 4))
    n_t8_8, h_t8_8 = qmap((3, 3))
    n_t8_4, h_t8_4 = qmap((3, 2))
    n_t4_8, h_t4_8 = qmap((2, 3))
    n_t4_4, h_t4_4 = qmap((2, 2))

    types = np.asarray(streams["type"], "<u2").tobytes()
    n_types = len(streams["type"])
    h_types = zb.add(types, 18, len(types) * 2 + 100) if n_types else None

    colors = np.frombuffer(bytes(streams["color"]), np.uint8).astype(np.int64)
    colors = (((colors * cfg.color_compression_lut3d) + 127) // 255
              ).astype(np.uint8).tobytes()
    h_colors = (zb.add(colors, 18, len(colors) * 2 + 100)
                if colors else None)

    n_idx, h_idx = {}, {}
    for bit in (3, 4, 5, 6):
        raw = bytes((np.frombuffer(bytes(streams[bit]), np.uint8)
                     .astype(np.int64) * 3).astype(np.uint8))
        n_idx[bit] = len(streams[bit])
        h_idx[bit] = zb.add(raw, 18, len(raw) * 2 + 100) if raw else None

    n_colors = len(colors)

    def mk():
        g = lambda hh: zb.get(hh) if hh is not None else b""
        z_t16_8, z_t8_16, z_t8_8 = g(h_t16_8), g(h_t8_16), g(h_t8_8)
        z_t8_4, z_t4_8, z_t4_4 = g(h_t8_4), g(h_t4_8), g(h_t4_4)
        z_types, z_colors = g(h_types), g(h_colors)
        z_idx = {bit: g(h_idx[bit]) for bit in (3, 4, 5, 6)}
        sizes16 = (n_t16_8, n_t8_16, n_t8_8, n_t4_8, n_t8_4, n_t4_4,
                   len(z_t16_8), len(z_t8_16), len(z_t8_8),
                   len(z_t4_8), len(z_t8_4), len(z_t4_4))
        # the reference's u16 map-size fields overflow >= 1 MPix; use the
        # u32-widened 3DTX extension there (see HeaderTile3DX)
        hdr_cls = HeaderTile3D if max(sizes16) <= 0xFFFF else HeaderTile3DX
        hdr = hdr_cls(
            stream_color_cnt=n_colors, stream_type_cnt=n_types,
            stream_3bit_cnt=n_idx[3], stream_4bit_cnt=n_idx[4],
            stream_5bit_cnt=n_idx[5], stream_6bit_cnt=n_idx[6],
            compr_type_size=len(z_types), compr_color_size=len(z_colors),
            compr_3bit_size=len(z_idx[3]), compr_4bit_size=len(z_idx[4]),
            compr_5bit_size=len(z_idx[5]), compr_6bit_size=len(z_idx[6]),
            size_t16_8_map=n_t16_8, size_t8_16_map=n_t8_16,
            size_t8_8_map=n_t8_8, size_t4_8_map=n_t4_8,
            size_t8_4_map=n_t8_4, size_t4_4_map=n_t4_4,
            size_t16_8_map_cmp=len(z_t16_8), size_t8_16_map_cmp=len(z_t8_16),
            size_t8_8_map_cmp=len(z_t8_8), size_t4_8_map_cmp=len(z_t4_8),
            size_t8_4_map_cmp=len(z_t8_4), size_t4_4_map_cmp=len(z_t4_4),
            component=7,
            compression_rate_color=(cfg.color_compression_lut3d
                                    if n_colors else 0))
        body = (hdr.pack() + z_idx[3] + z_idx[4] + z_idx[5] + z_idx[6]
                + z_types + z_colors + z_t16_8 + z_t8_16 + z_t8_8
                + z_t8_4 + z_t4_8 + z_t4_4)
        return _chunk(b"3DTL" if hdr_cls is HeaderTile3D else b"3DTX", body)
    return mk

