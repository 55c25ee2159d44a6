"""A .yaik stream in a form that does not depend on the zstd library.

zstd's compressed bytes differ between library versions (the card's host
has another libzstd than the machine that made the committed streams), so
two streams are compared by `canonical(stream)`: the file header, then per
chunk its tag, every header field but the compressed sizes, and each of its
zstd streams decompressed. Two streams with equal canonical forms carry the
same bitmaps, colours, indices and residuals, so they decode to the same
pixels; a stream that does not parse raises ValueError.

The alpha chunks: MIPM gives every header field and its bitmap, which is
not compressed; ALPM every field but the compressed size, and its payload
decompressed. The encoder compresses the ALPM payload at the smallest of
zstd levels 5 to 21, so its level, like its bytes, is the library's, and
the form holds neither.
"""
from __future__ import annotations

import dataclasses
import struct

from portbench.reference import swizzle, zstd
from portbench.reference.decoder import iter_chunks
from portbench.reference.headers import (MAGIC, AlphaHeader, FileHeader,
                                         Header1D, HeaderGradientTile,
                                         HeaderTile3D, HeaderTile3DX,
                                         MipmapHeader)

_MAPS = ("16_8", "8_16", "8_8", "8_4", "4_8", "4_4")
# each chunk's zstd streams in body order: (compressed-size field, the
# decompressed size as a function of the header and the image's w, h)
_T3D = ([(f"compr_{b}bit_size", lambda hd, w, h, b=b:
          getattr(hd, f"stream_{b}bit_cnt")) for b in (3, 4, 5, 6)]
        + [("compr_type_size", lambda hd, w, h: hd.stream_type_cnt * 2),
           ("compr_color_size", lambda hd, w, h: hd.stream_color_cnt)]
        + [(f"size_t{m}_map_cmp", lambda hd, w, h, m=m:
            getattr(hd, f"size_t{m}_map")) for m in _MAPS])
_LAYOUT = {
    b"GTIL": (HeaderGradientTile, [
        ("stream_bitmap_size", lambda hd, w, h: swizzle.bitmap_size_bytes(
            hd.format & 7, hd.format >> 3, w, h)),
        ("stream_rgb_size_zstd", lambda hd, w, h: hd.stream_rgb_size_custom)]),
    b"3DTL": (HeaderTile3D, _T3D),
    b"3DTX": (HeaderTile3DX, _T3D),
    b"1DTL": (Header1D, [
        ("stream_type_cnt", lambda hd, w, h: hd.stream_type_uncmp),
        ("stream_pixel_bit", lambda hd, w, h: hd.stream_pixel_uncmp)]),
    b"ALPM": (AlphaHeader, [
        ("stream_size", lambda hd, w, h: hd.expected_decompression_size)]),
}


def _mipm(body: bytes) -> tuple:
    """A MIPM chunk's header fields and the bitmap's bytes, as the decoder
    reads them (one bit a tile of its bbox)."""
    hdr = MipmapHeader.unpack(body)
    off = MipmapHeader.size()
    n = (hdr.w * hdr.h + 7) // 8
    bits = body[off:off + n]
    if len(bits) < n:
        raise ValueError("b'MIPM': its bitmap runs past the chunk")
    if any(body[off + n:]):
        raise ValueError("b'MIPM': bytes past its bitmap")
    return dataclasses.asdict(hdr), [bits]


def _chunk_form(tag: bytes, body: bytes, fh: FileHeader) -> tuple:
    """(tag, header fields, decompressed streams) of one chunk."""
    if tag == b"MIPM":
        return (tag, *_mipm(body))
    if tag not in _LAYOUT:
        raise ValueError(f"chunk {tag!r} has no canonical form here")
    cls, layout = _LAYOUT[tag]
    hdr = cls.unpack(body)
    off = cls.size()
    parts = []
    for field, usize in layout:
        csize = getattr(hdr, field)
        n = usize(hdr, fh.width, fh.height)
        parts.append(zstd.decompress(body[off:off + csize], n)
                     if csize else b"")
        off += csize
    if any(body[off:]):
        raise ValueError(f"{tag!r}: bytes past its streams")
    fields = {k: v for k, v in dataclasses.asdict(hdr).items()
              if k not in {f for f, _ in layout}}
    return (tag, fields, parts)


def canonical(stream: bytes) -> list:
    """[file header fields, (tag, header fields, decompressed streams)...]
    of a stream whose chunks are GTIL, 3DTL, 3DTX, 1DTL, MIPM and ALPM."""
    if len(stream) <= FileHeader.size():
        raise ValueError("stream too small")
    fh = FileHeader.unpack(stream)
    if fh.tag != MAGIC:
        raise ValueError("not a YAIK stream")
    try:
        return [dataclasses.astuple(fh)] + [
            _chunk_form(tag, body, fh) for tag, _, body in iter_chunks(stream)]
    except struct.error as e:
        raise ValueError(f"malformed chunk: {e}") from e
