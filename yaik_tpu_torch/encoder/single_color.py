"""SingleColorOut: greedy single-color palette maps -> UCOL chunk.

The port's copy of `yaik_tpu/encoder/single_color.py`.

Re-expresses the reference's disabled pass (EncoderContext.cpp:1771-2283,
call site commented out at :9036) with vectorized numpy in place of the
reference's per-pixel loops + 64 MB 4D histogram. Byte-exact vs the compiled
reference pass (tools/ref_encode_ucol_main.cpp goldens), including its
quirks:

- the greedy loop's LAST REJECTED color is still written to the palette and
  the index map (the reference's acknowledged "a bit buggy" TODO at
  :2172-2177);
- zstd level 15 (not the usual 18) for both streams (:2064, :2086);
- the map/span streams are rebuilt and recompressed every iteration, and the
  chunk uses the final iteration's streams;
- `prevStreamSize` is updated WITHOUT the palette bytes (:2168) while
  `diffSizeByte` includes them (:2100);
- cost comparison float math follows the reference's f32 `bitPerPixAdd`
  (NaN when a candidate adds 0 pixels and 0 bytes -> not skipped).

Documented deviation: when a stream is so small that the reference's
`byteSizeDecomp*2` zstd capacity cannot hold even a zstd frame header, the
reference feeds the zstd ERROR CODE to fwrite as a byte count (undefined
behavior, observed writing heap garbage). We floor the capacity at 128
instead; no well-formed reference stream is reachable in that regime.
"""
from __future__ import annotations

import numpy as np

from yaik_tpu_torch.entropy import zstd_backend as zstd
from yaik_tpu_torch.format.headers import HeaderBase, UniqueColorHeader

MAGENTA = (255, 0, 255)  # palette slot 0 (never stored; rgbc[0], :1791-1793)


def _swizzle_indices(bw: int, bh: int) -> np.ndarray:
    """GetCoordinateSwizzle (:1733-1744) for every bbox-local (y, x):
    idx = xL | yL<<3 | (xU + yU*(bw>>3))<<6, as an [bh, bw] i64 map."""
    y = np.arange(bh)[:, None]
    x = np.arange(bw)[None, :]
    return (x & 7) | ((y & 7) << 3) | (((x >> 3) + (y >> 3) * (bw >> 3)) << 6)


def _build_spans(map_pixel: np.ndarray):
    """Empty-span scan (:1895-1947) + >=16 filter + used-span walk
    (:2021-2051). Returns (used_spans [n,2] u32 (deltaStart, length),
    palette_stream bytes)."""
    nz = map_pixel != 0
    n = map_pixel.size
    # maximal zero runs: starts/ends via edges of the nonzero indicator
    edges = np.diff(nz.view(np.int8), prepend=np.int8(1), append=np.int8(1))
    starts = np.flatnonzero(edges == -1)
    ends = np.flatnonzero(edges == 1)
    big = (ends - starts) >= 16          # compressedSpan filter (:1936)

    used = []
    chunks = []
    pos = 0
    last = 0
    for s, e in zip(starts[big], ends[big]):
        if pos < s:
            used.append((pos - last, s - pos))
            chunks.append(map_pixel[pos:s])
            last = pos
        pos = e
    if pos < n:
        used.append((pos - last, n - pos))
        chunks.append(map_pixel[pos:])
    stream = b"".join(c.tobytes() for c in chunks)
    spans = np.asarray(used, "<u4").reshape(-1, 2)
    # verifyComp (:1749-1769): replay must reproduce the map
    replay = np.zeros(n, np.uint8)
    p = 0
    off = 0
    for d, ln in used:
        p += d
        replay[p:p + ln] = np.frombuffer(stream, np.uint8, ln, off)
        off += ln
    assert np.array_equal(replay, map_pixel), "UCOL span replay mismatch"
    return spans, stream


def single_color_out(planes: np.ndarray, mip_mask: np.ndarray | None,
                     bound: tuple[int, int, int, int],
                     favor_accuracy: bool = False,
                     swizzling: bool = True) -> tuple[bytes, np.ndarray]:
    """Run the greedy single-color loop over `planes` [3, H, W] i32.

    mip_mask: [H, W] bool, True where RGB is meaningful (the mipmapMask);
    bound: (x0, y0, x1, y1) pixel bbox (boundX0..boundY1, exclusive ends).
    Returns (UCOL chunk bytes, updated mip_mask). The chunk is always
    emitted, like the reference (:2179-2227)."""
    _, h, w = planes.shape
    x0, y0, x1, y1 = bound
    bw, bh = x1 - x0, y1 - y0
    map_size = bw * bh
    if swizzling and (bw & 7):
        raise ValueError("swizzled UCOL needs an 8px-aligned bbox width")

    packed = ((planes[0].astype(np.int64) << 16)
              | (planes[1].astype(np.int64) << 8) | planes[2])
    box = (slice(y0, y1), slice(x0, x1))
    if mip_mask is None:
        mip_mask = np.ones((h, w), bool)
    mask_processed = mip_mask.copy()      # MaskProcessed (:1805)
    mip_out = mip_mask.copy()

    if swizzling:
        widx_map = _swizzle_indices(bw, bh)
    else:
        widx_map = (np.arange(bh)[:, None] * bw + np.arange(bw)[None, :])

    map_pixel = np.zeros(map_size, np.uint8)
    rgbc = [MAGENTA]
    color_id = 1
    valid_count = 0
    prev_valid = 0
    prev_stream = 0

    while True:
        # -- histogram argmax over bbox under MaskProcessed (:1811-1819) --
        live = packed[box][mask_processed[box]]
        if live.size:
            vals, counts = np.unique(live, return_counts=True)
            found = int(vals[np.argmax(counts)])   # first max = smallest val
        else:
            found = 0                              # all-zero histogram (:1813)
        rgb = ((found >> 16) & 0xFF, (found >> 8) & 0xFF, found & 0xFF)
        if color_id == len(rgbc):
            rgbc.append(rgb)
        else:
            rgbc[color_id] = rgb                   # skipColor overwrite slot

        # -- exact-match mask, FillOutside(bbox) (:1836-1837) --
        color_mask = (packed == found)
        in_box = np.zeros((h, w), bool)
        in_box[box] = True
        color_mask &= in_box

        cyx = np.nonzero(color_mask[box])
        widx = widx_map[cyx]
        map_pixel[widx] = color_id
        valid_count += widx.size

        spans, stream = _build_spans(map_pixel)
        byte_size_decomp = len(stream)
        size_blk = spans.size * 4
        z_map = zstd.compress(stream, 15, max(byte_size_decomp * 2, 128))
        z_spans = zstd.compress(spans.tobytes(), 15, max(size_blk * 2, 128))

        # -- accept / skip cost model (:2093-2106) --
        iresult, result2 = len(z_map), len(z_spans)
        flat_without = valid_count * 7
        flat_with = iresult * 8 + color_id * 24 + result2 * 8
        diff_pix = valid_count - prev_valid
        diff_size = (iresult + result2 + color_id * 3) - prev_stream
        with np.errstate(divide="ignore", invalid="ignore"):
            bit_per_pix = np.float32(diff_size * 8.0) / np.float32(diff_pix)
        skip = False if favor_accuracy else bool(bit_per_pix > 7.0)

        mask_processed[color_mask] = False         # both branches (:2117,2177)
        if (color_id < 85) and (flat_without >= flat_with) \
                and (favor_accuracy or diff_pix > 150):
            if not skip:
                mip_out[color_mask] = False        # (:2120)
                color_id += 1
                prev_valid = valid_count
                prev_stream = iresult + result2    # palette bytes NOT added
            else:
                valid_count = prev_valid           # rollback (:2133-2150)
                map_pixel[widx] = 0
            continue
        break                                       # rejected color stays in!

    # -- chunk emit (:2179-2227) --
    hdr = UniqueColorHeader(
        x=x0, y=y0, w=bw, h=bh,
        stream_size=iresult,
        expected_decompression_size=byte_size_decomp,
        stream_size_e=result2,
        expected_decompression_skippers=size_blk,
        version=2 if swizzling else 1,
        color_count=(color_id + 1) & 0xFF)
    palette = bytes(v for c in rgbc[1:color_id + 1] for v in c)
    body = hdr.pack() + palette + z_map + z_spans
    length = (len(body) + 3) & ~3
    chunk = (HeaderBase(b"UCOL", length).pack() + body
             + b"\0" * (length - len(body)))
    return chunk, mip_out
