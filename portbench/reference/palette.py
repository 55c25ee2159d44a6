"""The custom lossless RGB-delta palette codec (decoder side): a frozen
copy of the port's `entropy/palette.py`, its pure-Python body only.

Stream grammar (decoder twin in reference `decoder/YAIK_GenericFunctions.cpp:
139-241`, encoder `encoder/EncoderContext.cpp:3259-3502`):

  [codeBookSize u8][codebook codeBookSize*3][first RGB 3 bytes] then codes:
    [0][7b idx]            color = last + codebook[idx]            (u8 wrap)
    [1][1][6b n]           re-point "last color" (n+2) entries back
    [1][0][000][3b mask]   color = last + per-channel delta bytes (mask-gated)
    [1][0][001][3b mask]   color = per-channel absolute bytes, else last's

Colors are in posterized space; a final full-range remap
v -> (v * ((255<<16)//range)) >> 16 restores 0..255
(PaletteFullRangeRemapping :128-137).
"""
from __future__ import annotations

import numpy as np

_BITCOUNT = (0, 1, 1, 2, 1, 2, 2, 3)


def full_range_remap(data: np.ndarray, original_range: int) -> np.ndarray:
    """v -> (v * invMul) >> 16, invMul = (255<<16)//range (or 255<<16 if 0)."""
    inv = ((255 << 16) // original_range) if original_range else (255 << 16)
    return ((data.astype(np.int64) * inv) >> 16).astype(np.uint8)


def palette_decompress(input_: bytes, output_size: int,
                       color_compression: int) -> np.ndarray:
    """Decode `output_size` bytes of RGB triplets. Returns u8 array.
    The pure-Python body: the frozen reference runs no native code."""
    inp = np.frombuffer(input_, np.uint8)
    out = np.zeros(output_size, np.uint8)
    pos = 0
    cb_size = int(inp[pos]); pos += 1
    # The reference maps the codebook IN PLACE on the input stream
    # (YAIK_GenericFunctions.cpp:155 "codeBook = input") and the encoder
    # emits indices >= codeBookSize, which deterministically read the stream
    # bytes that follow the codebook (first color, codes...). Reproduce that:
    # the codebook view covers input[1:1+128*3], zero-padded past the end
    # (the reference over-allocates by a 128*3 security offset).
    codebook = np.zeros(128 * 3, np.int32)
    avail = inp[pos:pos + 128 * 3]
    codebook[:avail.size] = avail
    pos += cb_size * 3
    out[0:3] = inp[pos:pos + 3]; pos += 3
    last = 0          # byte offset of "last color" in out
    write = 3
    n = len(inp)
    while write <= output_size - 3:
        if pos >= n:
            raise ValueError("palette stream truncated")
        c = int(inp[pos]); pos += 1
        if c & 0x80:
            if c & 0x40:
                last = write - ((c & 0x3F) + 2) * 3
                if last < 0:
                    raise ValueError("palette back-reference out of range")
            else:
                sub = (c >> 3) & 7
                if sub == 0:
                    for i in range(3):
                        d = int(inp[pos]) if (c & (1 << i)) else 0
                        if c & (1 << i):
                            pos += 1
                        out[write + i] = (int(out[last + i]) + d) & 0xFF
                elif sub == 1:
                    for i in range(3):
                        if c & (1 << i):
                            out[write + i] = inp[pos]; pos += 1
                        else:
                            out[write + i] = out[last + i]
                else:
                    raise ValueError(f"palette: reserved opcode {sub}")
                last = write
                write += 3
        else:
            code = codebook[(c & 0x7F) * 3:(c & 0x7F) * 3 + 3]
            out[write:write + 3] = (out[last:last + 3].astype(np.int32)
                                    + code).astype(np.uint8)
            last = write
            write += 3
    return full_range_remap(out, color_compression)
