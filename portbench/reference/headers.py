"""YAIK bitstream structures (shared encoder/decoder contract): a frozen
copy of the port's `format/headers.py` (:63-95 for the alpha chunks),
holding the structs of the chunks a default RGB or RGBA encode writes, and
the LUT file's.

Byte-exact mirrors of the C structs in the reference `include/YAIK_private.h`
(FileHeader :96-105, HeaderBase :107-110, MipmapHeader :112-118,
AlphaHeader :120-141, HeaderGradientTile :172-288, HeaderTile3D :302-345,
Header1D :347-356). All little-endian; sizes include MSVC/gcc struct padding,
verified against reference-encoded streams in tests/fixtures.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, fields

MAGIC = b"YAIK"
END_TAG = 0xDEADBEEF


class _Struct:
    """Tiny declarative struct helper: subclasses define _fmt (little-endian
    struct format, one code per dataclass field, 'x' pads allowed)."""
    _fmt: str = ""

    @classmethod
    def size(cls) -> int:
        return struct.calcsize("<" + cls._fmt)

    @classmethod
    def unpack(cls, buf: bytes, off: int = 0):
        vals = struct.unpack_from("<" + cls._fmt, buf, off)
        return cls(*vals)

    def pack(self) -> bytes:
        vals = [getattr(self, f.name) for f in fields(self)]
        return struct.pack("<" + self._fmt, *vals)


@dataclass
class FileHeader(_Struct):
    # 'YAIK' tag handled separately (tag bytes precede these fields)
    _fmt = "4sHHHH"
    tag: bytes
    version: int
    width: int
    height: int
    info_mask: int  # bit0 = has alpha

    @property
    def has_alpha(self) -> bool:
        return bool(self.info_mask & 1)


@dataclass
class HeaderBase(_Struct):
    _fmt = "4sI"
    tag: bytes
    length: int  # rounded up to multiple of 4, excludes this header


@dataclass
class MipmapHeader(_Struct):
    # bbox(8) + u32 + u8 + u8 + 2 pad = 16
    _fmt = "hhhhIBB2x"
    x: int
    y: int
    w: int
    h: int
    stream_size: int
    version: int
    mipmap_level: int


@dataclass
class AlphaHeader(_Struct):
    # bbox(8) + u32 + u32 + u8 + u8 + 2 pad = 20
    _fmt = "hhhhIIBB2x"
    x: int
    y: int
    w: int
    h: int
    stream_size: int
    expected_decompression_size: int
    version: int
    parameters: int

    # parameters & 7 (AlphaHeader::ALPHA_PARAM)
    IS_1_BIT_USEMIPMAPMASK = 0
    IS_1_BIT_FULL = 1
    IS_6_BIT_USEMIPMAPMASK = 2
    IS_6_BIT_USEMIPMAPMASK_INVERSE = 3
    IS_6_BIT_FULL = 4
    IS_6_BIT_FULL_INVERSE = 5
    IS_8_BIT_FULL = 6


@dataclass
class HeaderGradientTile(_Struct):
    # bbox(8) + 4*u32(16) + 4*u8 = 28, no padding
    _fmt = "hhhhIIIIBBBB"
    x: int
    y: int
    w: int
    h: int
    stream_bitmap_size: int
    stream_rgb_size_zstd: int
    stream_rgb_size_custom: int
    stream_rgb_size_uncompressed: int
    color_compression: int
    version: int
    format: int  # (log2 tw) | (log2 th << 3)
    plane: int   # bit0 R, bit1 G, bit2 B

    @property
    def shift_x(self) -> int:
        return self.format & 7

    @property
    def shift_y(self) -> int:
        return (self.format >> 3) & 7


@dataclass
class HeaderTile3D(_Struct):
    # 12 u32 (48) + 12 u16 (24) + 2 u8 + 2 pad = 76
    _fmt = "IIIIIIIIIIII" + "HHHHHH" + "HHHHHH" + "BB2x"
    stream_color_cnt: int
    stream_type_cnt: int
    stream_3bit_cnt: int
    stream_4bit_cnt: int
    stream_5bit_cnt: int
    stream_6bit_cnt: int
    compr_type_size: int
    compr_color_size: int
    compr_3bit_size: int
    compr_4bit_size: int
    compr_5bit_size: int
    compr_6bit_size: int
    size_t16_8_map: int
    size_t8_16_map: int
    size_t8_8_map: int
    size_t4_8_map: int
    size_t8_4_map: int
    size_t4_4_map: int
    size_t16_8_map_cmp: int
    size_t8_16_map_cmp: int
    size_t8_8_map_cmp: int
    size_t4_8_map_cmp: int
    size_t8_4_map_cmp: int
    size_t4_4_map_cmp: int
    component: int
    compression_rate_color: int


@dataclass
class HeaderTile3DX(_Struct):
    """Large-image extension of HeaderTile3D (tag '3DTX'): identical layout
    with the 12 u16 map-size fields widened to u32. The reference format's
    u16 fields overflow for any image >= 1 MPix (the 4x4 tile map is
    w*h/16 bytes), so the reference cannot encode 4K at all; streams that
    fit u16 still use '3DTL' and stay byte-identical."""
    _fmt = "IIIIIIIIIIII" + "IIIIIIIIIIII" + "BB2x"
    stream_color_cnt: int
    stream_type_cnt: int
    stream_3bit_cnt: int
    stream_4bit_cnt: int
    stream_5bit_cnt: int
    stream_6bit_cnt: int
    compr_type_size: int
    compr_color_size: int
    compr_3bit_size: int
    compr_4bit_size: int
    compr_5bit_size: int
    compr_6bit_size: int
    size_t16_8_map: int
    size_t8_16_map: int
    size_t8_8_map: int
    size_t4_8_map: int
    size_t8_4_map: int
    size_t4_4_map: int
    size_t16_8_map_cmp: int
    size_t8_16_map_cmp: int
    size_t8_8_map_cmp: int
    size_t4_8_map_cmp: int
    size_t8_4_map_cmp: int
    size_t4_4_map_cmp: int
    component: int
    compression_rate_color: int


@dataclass
class Header1D(_Struct):
    # 4 u32 + 3 u8 + 1 pad = 20
    _fmt = "IIIIBBB1x"
    stream_pixel_bit: int     # compressed size of pixel stream
    stream_pixel_uncmp: int
    stream_type_cnt: int      # compressed size of type stream
    stream_type_uncmp: int
    compression_color: int
    compression_range: int
    version: int


@dataclass
class LUTHeader(_Struct):
    # 4 u8 tag + u8 version + u8 entryCount + 2 pad = 8
    _fmt = "4sBB2x"
    tag: bytes          # 'LUL0' for 3D
    version: int
    entry_count: int    # stored count-1: tables = entry_count + 1
