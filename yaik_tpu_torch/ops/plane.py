"""Pixel-plane functions of the encoder's host passes: the port's copy of
what it calls of `yaik_tpu/ops/plane.py` (vectorized equivalents of the
reference's encoder framework, encoder/Plane.cpp and EncoderContext.cpp).
Host numpy only; no kernel lives here.

Planes are plain numpy int arrays [h, w] with the reference's exact
integer semantics (C truncating '/' noted where it differs from floor
division).

Reference map:
  erosion                 Plane::Erosion (:123) incl. flood-fill cull <= 50 px
  reduce_quarter_logic_max Plane::ReduceQuarterLogicMax (:211)
  sample_down             Plane::SampleDown (:278)
  apply_diff              Plane::ApplyDiff (:466) + ParsingOrder iterators
  bbox_nonzero            Plane::GetBoundingBoxNonZeros (:16)
  rgb_to_ycocg etc        EncoderContext.cpp:53-117
"""
from __future__ import annotations

import numpy as np


def bbox_nonzero(plane):
    """(x, y, w, h) of the nonzero extent; (0,0,0,0) when empty."""
    ys, xs = np.nonzero(plane)
    if ys.size == 0:
        return (0, 0, 0, 0)
    return (int(xs.min()), int(ys.min()),
            int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1))


def _flood_count(plane, sy, sx):
    """Iterative flood fill of 255-valued region, marking 128; returns size."""
    h, w = plane.shape
    stack = [(sy, sx)]
    count = 0
    while stack:
        y, x = stack.pop()
        if y < 0 or y >= h or x < 0 or x >= w or plane[y, x] != 255:
            continue
        plane[y, x] = 128
        count += 1
        stack.extend(((y, x + 1), (y, x - 1), (y + 1, x), (y - 1, x)))
    return count


def _flood_zero(plane, sy, sx):
    h, w = plane.shape
    stack = [(sy, sx)]
    while stack:
        y, x = stack.pop()
        if y < 0 or y >= h or x < 0 or x >= w:
            continue
        v = plane[y, x]
        if v == 0 or v > 128:
            continue
        plane[y, x] = 0
        stack.extend(((y, x + 1), (y, x - 1), (y + 1, x), (y - 1, x)))


def erosion(plane: np.ndarray, min_region: int = 50) -> np.ndarray:
    """In-place: remove isolated 1-2 pixel specks (scan order), then cull
    connected regions of <= min_region pixels."""
    h, w = plane.shape
    p = plane

    def at(y, x):
        if 0 <= y < h and 0 <= x < w:
            return p[y, x]
        return p[min(max(y, 0), h - 1), min(max(x, 0), w - 1)]

    for y in range(h):
        for x in range(w):
            if p[y, x] and not (at(y - 1, x) or at(y + 1, x)
                                or at(y, x - 1) or at(y, x + 1)):
                p[y, x] = 0
    for y in range(h):
        for x in range(w):
            if (p[y, x] and at(y, x + 1)
                    and not (at(y - 1, x) or at(y + 1, x) or at(y, x - 1)
                             or at(y, x + 2) or at(y - 1, x + 1)
                             or at(y + 1, x + 1))):
                p[y, x] = 0
                if x + 1 < w:
                    p[y, x + 1] = 0
    for y in range(h):
        for x in range(w):
            if (p[y, x] and at(y + 1, x)
                    and not (at(y - 1, x) or at(y + 2, x) or at(y, x - 1)
                             or at(y, x + 1) or at(y + 1, x - 1)
                             or at(y + 1, x + 1))):
                p[y, x] = 0
                if y + 1 < h:
                    p[y + 1, x] = 0

    for y in range(h):
        for x in range(w):
            count = _flood_count(p, y, x)
            if 1 <= count <= min_region:
                _flood_zero(p, y, x)
    p[p != 0] = 255
    return p


def reduce_quarter_logic_max(plane):
    h, w = plane.shape
    q = plane[: h // 2 * 2, : w // 2 * 2].reshape(h // 2, 2, w // 2, 2)
    return np.where((q != 0).all(axis=(1, 3)), 255, 0).astype(plane.dtype)


def sample_down(plane, half_x, half_y, mode="average"):
    """Modes: average, nearest_tl, nearest_br, max, min (EDownSample).
    C '/' on non-negative values == //."""
    if not (half_x or half_y):
        return plane.copy()
    h, w = plane.shape
    p = plane.astype(np.int64)
    A = p[::2 if half_y else 1, ::2 if half_x else 1]
    B = p[::2 if half_y else 1, 1::2] if half_x else A
    C = p[1::2, ::2 if half_x else 1] if half_y else A
    D = p[1::2, 1::2] if (half_x and half_y) else (C if half_x else B)
    if mode == "average":
        # C '/' truncates toward zero - matters for signed (Co/Cg) planes
        def cdiv(s, d):
            return np.sign(s) * (np.abs(s) // d)
        if half_x and half_y:
            v = cdiv(A + B + C + D, 4)
        elif half_x:
            v = cdiv(A + B, 2)
        else:
            v = cdiv(A + C, 2)
    elif mode == "nearest_tl":
        v = A
    elif mode == "nearest_br":
        v = D if (half_x and half_y) else (C if half_x else B)
    elif mode == "max":
        v = np.maximum(np.maximum(A, B), np.maximum(C, D))
        if half_x and not half_y:
            v = np.maximum(A, C)   # reference quirk (x-only uses A/C)
        elif half_y and not half_x:
            v = np.maximum(A, B)
    elif mode == "min":
        v = np.minimum(np.minimum(A, B), np.minimum(C, D))
        if half_x and not half_y:
            v = np.minimum(A, C)
        elif half_y and not half_x:
            v = np.minimum(A, B)
    else:
        raise ValueError(mode)
    return v.astype(plane.dtype)


def parsing_order(w, h, block, order="left_right"):
    """Yield (x, y, is_row_start) block origins in traversal order."""
    if order == "left_right":
        for y in range(0, h, block):
            for x in range(0, w, block):
                yield x, y, x == 0
    elif order == "top_down":
        for x in range(0, w, block):
            for y in range(0, h, block):
                yield x, y, y == 0
    else:
        raise ValueError(order)


def apply_diff(plane, block=1, order="left_right"):
    """Delta-encode block origins in parsing order (row starts keep value)."""
    h, w = plane.shape
    out = np.zeros_like(plane)
    prev = 0
    for x, y, is_marker in parsing_order(w, h, block, order):
        out[y, x] = plane[y, x] if is_marker else plane[y, x] - prev
        prev = plane[y, x]
    return out


def _cdiv2(v):
    return np.sign(v) * (np.abs(v) // 2)


def rgb_to_ycocg(r, g, b):
    """Lossy /2 chroma (RGBtoYCoCg :53)."""
    co = r - b
    tmp = b + _cdiv2(co)
    cg = g - tmp
    y = tmp + _cdiv2(cg)
    return y, _cdiv2(co), _cdiv2(cg)


def ycocg_to_rgb(y, co, cg):
    """YCoCgtoRGB (:103)."""
    co = co * 2
    cg = cg * 2
    tmp = y - _cdiv2(cg)
    g = cg + tmp
    b = tmp - _cdiv2(co)
    r = b + co
    return r, g, b
