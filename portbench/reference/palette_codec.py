"""PaletteCompressor: the custom lossless RGB-delta encoder (host fallback of
the native `palette_compress`). A frozen copy of
the port's `encoder/palette_codec.py`.

Mirrors reference `EncoderContext.cpp:3259-3502` (+ registerCodeBook :3231,
FindCodeBook :3248). Two phases:

1. Codebook build: for each color, the min-squared-distance delta against the
   previous <=64 colors (first-best-wins ties) is registered (first-occurrence
   order, refcounted: first use counts 0). Entry 0 is pinned (0,0,0); entries
   1.. are sorted by refcount descending. The reference uses libc qsort whose
   tie ordering is implementation-defined; we replicate a STABLE descending
   sort, which matches glibc's mergesort-based qsort used to build the golden
   fixtures (verified in tests against the compiled reference).
2. Emission per color: immediate-prev delta in codebook (search limited to
   the first 64 entries) -> codebook byte; else best back-reference (smallest
   codebook index; nearest jump on ties, distance < 64) -> [0xC0|dist][code];
   else delta-from-input-prev escape [0x80|mask]+bytes if all deltas fit
   s8, else absolute escape [0x88|mask]+bytes.
"""
from __future__ import annotations

import numpy as np


class PaletteState:
    """The reference's global CodeRGB array (EncoderContext.cpp:3216).

    registerCodeBook resets CodeCount=0 per call but never clears old
    entries, and FindCodeBook scans entries 0..63 unconditionally - so when
    the current codebook has fewer than 64 entries, STALE entries from the
    previous chunk's compression are still matchable (and the decoder's
    in-place codebook aliasing then reads whatever stream bytes sit at that
    index - a silent encoder/decoder divergence the reference ships with).
    State persists across chunks within one encoder process.
    """

    def __init__(self):
        self.entries: list[tuple[int, int, int]] = []


def _build_codebook(cols: np.ndarray, state: PaletteState):
    """cols: i32 [n,3]. Returns (emitted book, search lookup over slots
    0..63 of the persistent entry array)."""
    n = len(cols)
    book = [(0, 0, 0)]
    index = {(0, 0, 0): 0}
    refs = [0]
    for i in range(1, n):
        lo = max(0, i - 64)
        window = cols[lo:i]
        d = cols[i] - window                      # [w, 3]
        dist = (d * d).sum(axis=1)
        j = int(dist.argmin())                    # first min wins (strict <)
        key = (int(d[j, 0]), int(d[j, 1]), int(d[j, 2]))
        if key in index:
            refs[index[key]] += 1
        else:
            index[key] = len(book)
            book.append(key)
            refs.append(0)
    # stable descending sort of entries 1.. by refcount (entry 0 pinned);
    # glibc qsort (used for the goldens) is mergesort-based = stable
    order = sorted(range(1, len(book)), key=lambda k: -refs[k])
    book = [book[0]] + [book[k] for k in order]
    # overwrite the persistent array's first len(book) slots
    state.entries[:len(book)] = book
    emitted = book[:128]
    # FindCodeBook scans persistent slots 0..63 (stale tail included)
    lookup = {}
    for k, key in enumerate(state.entries[:64]):
        if key not in lookup:
            lookup[key] = k
    return emitted, lookup


def palette_compress(data: bytes, state: PaletteState | None = None) -> bytes | None:
    """Compress RGB triplets; returns stream or None on failure (the
    reference fails only on output overflow, capacity 3x input)."""
    inp = np.frombuffer(data, np.uint8).astype(np.int32)
    n = len(inp) // 3
    cols = inp.reshape(n, 3)
    book, lookup = _build_codebook(cols, state if state is not None
                                   else PaletteState())

    out = bytearray()
    out.append(len(book))
    for (dr, dg, db) in book:
        out.append(dr & 0xFF)
        out.append(dg & 0xFF)
        out.append(db & 0xFF)
    out += bytes(int(v) for v in cols[0])

    for i in range(1, n):
        pix = cols[i]
        lo = max(0, i - 65)
        # immediate previous color delta in codebook?
        d = pix - cols[i - 1]
        key = (int(d[0]), int(d[1]), int(d[2]))
        k = lookup.get(key)
        if k is not None:
            out.append(k & 0x7F)
            continue
        # back-reference search: prev from i-2 down to lo, smallest codebook
        # index wins; nearest jump (first found) wins ties; distance < 64
        best_idx = 999
        best_dist = 0
        for prev in range(i - 2, lo - 1, -1):
            dd = pix - cols[prev]
            kk = lookup.get((int(dd[0]), int(dd[1]), int(dd[2])))
            if kk is not None:
                distance = (i - prev) - 2
                if distance < 64 and kk < best_idx:
                    best_idx = kk
                    best_dist = distance
        if best_idx != 999:
            out.append(0xC0 | (best_dist & 0x3F))
            out.append(best_idx & 0x7F)
            continue
        # escape codes relative to the previous INPUT color
        dr = int(pix[0] - cols[i - 1, 0])
        dg = int(pix[1] - cols[i - 1, 1])
        db = int(pix[2] - cols[i - 1, 2])
        mask = (1 if dr else 0) | (2 if dg else 0) | (4 if db else 0)
        if -128 <= dr <= 127 and -128 <= dg <= 127 and -128 <= db <= 127:
            out.append(0x80 | mask)
            if dr:
                out.append(dr & 0xFF)
            if dg:
                out.append(dg & 0xFF)
            if db:
                out.append(db & 0xFF)
        else:
            out.append(0x88 | mask)
            if dr:
                out.append(int(pix[0]))
            if dg:
                out.append(int(pix[1]))
            if db:
                out.append(int(pix[2]))

    if len(out) >= len(data) * 3:
        return None
    return bytes(out)
