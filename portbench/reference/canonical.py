"""A .yaik stream in a form that does not depend on the zstd library.

zstd's compressed bytes differ between library versions (the card's host
has another libzstd than the machine that made the committed streams), so
two streams are compared by `canonical(stream)`: the file header, then per
chunk its tag, every header field but the compressed sizes, and each of its
zstd streams decompressed. Two streams with equal canonical forms carry the
same bitmaps, colours, indices and residuals, so they decode to the same
pixels; a stream that does not parse raises ValueError.
"""
from __future__ import annotations

import dataclasses

from portbench.reference import swizzle, zstd
from portbench.reference.decoder import iter_chunks
from portbench.reference.headers import (MAGIC, FileHeader, Header1D,
                                         HeaderGradientTile, HeaderTile3D,
                                         HeaderTile3DX)

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
}


def canonical(stream: bytes) -> list:
    """[file header fields, (tag, header fields, decompressed streams)...]
    of a stream whose chunks are GTIL, 3DTL, 3DTX and 1DTL."""
    if len(stream) <= FileHeader.size():
        raise ValueError("stream too small")
    fh = FileHeader.unpack(stream)
    if fh.tag != MAGIC:
        raise ValueError("not a YAIK stream")
    out: list = [dataclasses.astuple(fh)]
    for tag, _, body in iter_chunks(stream):
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
        out.append((tag, fields, parts))
    return out
