"""DynamicTileCompressor: the 1D residual pass (host fallback of the native
`dyn1d_plane`). A frozen copy of the port's `encoder/dyn1d.py`.

Mirrors reference `EncoderContext.cpp:8398-8522` (+ FindAndRemoveMostUsedColor
:8335, Model1 :8359, GetValueModel1 :8384). Per 8x8 tile with any unclaimed
4x4 quad (per plane): histogram of posterized values -> most-used color
(ties to the RIGHT); values within +-1 encode as 0; the rest quantize to
1 + trunc(((v-min)*range + (delta>>1) - 1) / delta) against the min/delta of
the remaining histogram. Emits per-tile (color0, min, delta) triplets into
the shared type stream and bytes into the pixel stream.
"""
from __future__ import annotations

import numpy as np


def _trunc_div(a: int, b: int) -> int:
    """C integer division (truncate toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def compress_f(v, rate):
    return ((v * rate) + 127) // 255


def run_plane(plane: np.ndarray, claim: np.ndarray, pix_stream: bytearray,
              type_stream: bytearray, color_compression: int,
              range_compression: int):
    """One DynamicTileCompressor call (single plane).
    plane: [H,W] int; claim: [H,W] bool (mapSmoothTile plane)."""
    h, w = plane.shape
    for y in range(0, h, 8):
        for x in range(0, w, 8):
            vals = []
            for y2 in (0, 4):
                has_left = not claim[y + y2, x]
                has_right = not claim[y + y2, x + 4]
                if has_left or has_right:
                    if has_left and has_right:
                        x2, length = 0, 8
                    elif has_right:
                        x2, length = 4, 4
                    else:
                        x2, length = 0, 4
                    block = plane[y + y2:y + y2 + 4, x + x2:x + x2 + length]
                    vals.append(compress_f(block.astype(np.int64),
                                           color_compression).reshape(-1))
            if not vals:
                continue
            v = np.concatenate(vals)
            histo = np.bincount(v, minlength=256)
            # most-used color: ties to the right (>=), clamp 1..254
            color0 = int(255 - histo[::-1].argmax())
            color0 = min(max(color0, 1), 254)
            histo[color0 - 1:color0 + 2] = 0
            nz = np.flatnonzero(histo)
            if nz.size:
                min_col, delta = int(nz[0]), int(nz[-1] - nz[0])
            else:
                min_col, delta = 0, 0
            for val in v.tolist():
                if color0 - 1 <= val <= color0 + 1:
                    pix_stream.append(0)
                else:
                    if delta:
                        idx = _trunc_div((val - min_col) * range_compression
                                         + (delta >> 1) - 1, delta)
                    else:
                        idx = 0
                    pix_stream.append((1 + idx) & 0xFF)
            type_stream.append(color0)
            type_stream.append(min_col)
            type_stream.append(delta)
