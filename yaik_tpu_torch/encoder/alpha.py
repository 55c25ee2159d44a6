"""Alpha-plane compression + alpha-zero mipmap rejection bitmap: the
port's copy of `yaik_tpu/encoder/alpha.py`.

Ports of the reference's decoder-supported but pipeline-disabled passes
(EncoderContext.cpp: MipPrefilter :1257-1427 with quadRecursion :357-430,
ProcessAlpha :1429-1682 with make1BitStream :317-355). The reference's
Convert() has these calls commented out (:9027-9028); we expose them as
config-gated passes so RGBA sprite sheets and mipmapped textures round-trip
(BASELINE configs 2-3).

Emission notes (matching the C code):
- MIPM: 1 bit per 16x16 tile ("RGB is garbage" where alpha==0 over the whole
  tile), uncompressed, only when the non-garbage bbox is smaller than the
  image. MipmapHeader.streamSize is uninitialized upstream; we write the
  actual byte size.
- ALPM: zstd level swept 5..21 (best size wins, ties keep earlier level).
  Analog alpha -> 6-bit packed (optionally inverted / mipmap-sparse) or
  8-bit full; binary alpha -> 1-bit rows (8-px aligned bbox).
- All-0 / all-1 alpha emits NO chunk (reference behavior); our decoder then
  defaults the alpha channel to 255.
"""
from __future__ import annotations

import numpy as np

from yaik_tpu_torch.encoder.context import _chunk
from yaik_tpu_torch.entropy import zstd_backend as zstd
from yaik_tpu_torch.format.headers import AlphaHeader, MipmapHeader
from yaik_tpu_torch.utils import profiler


def _zstd_sweep(data: bytes) -> bytes:
    """Level sweep 5..21, keep the smallest (first-best on ties); break when
    size grows past the best (EncoderContext.cpp:1590-1615). Counts every
    compression, the final one included (`alpm_sweep_compressions`)."""
    best, best_lvl = None, 5
    for lvl in range(5, 22):
        z = zstd.compress(data, lvl, len(data) * 2)
        profiler.count("alpm_sweep_compressions")
        if best is None or len(z) < best:
            best, best_lvl = len(z), lvl
        elif len(z) > best:
            break
    profiler.count("alpm_sweep_compressions")
    return zstd.compress(data, best_lvl, len(data) * 2)


def mip_prefilter(alpha: np.ndarray, tile_shift: int = 4):
    """Quadtree alpha-zero rejection. Returns (mip_mask [H,W] bool where True
    = RGB meaningful, chunk bytes or None, bbox in pixels).

    tile_shift=4 -> 16px tiles (maxMipLevel=3 upstream; the decoder only
    implements 16px, YAIK_Mipmap.cpp:53)."""
    h, w = alpha.shape
    ts = 1 << tile_shift
    nty, ntx = (h + ts - 1) // ts, (w + ts - 1) // ts
    # a tile is "garbage" iff every alpha pixel in it is zero
    pad_h, pad_w = nty * ts, ntx * ts
    a = np.zeros((pad_h, pad_w), alpha.dtype)
    a[:h, :w] = alpha
    tiles_zero = (a.reshape(nty, ts, ntx, ts).max(axis=(1, 3)) == 0)
    keep = ~tiles_zero                        # 1 = RGB meaningful

    mip_mask = np.repeat(np.repeat(keep, ts, axis=0), ts, axis=1)[:h, :w]
    if keep.all():
        return np.ones((h, w), bool), None, (0, 0, w, h)

    ty, tx = np.nonzero(keep)
    if ty.size == 0:
        # fully transparent image: bbox empty; reference would keep the full
        # mask and emit nothing
        return np.ones((h, w), bool), None, (0, 0, w, h)
    tx0, tx1 = int(tx.min()), int(tx.max()) + 1
    ty0, ty1 = int(ty.min()), int(ty.max()) + 1
    if (tx0, ty0, tx1 * ts, ty1 * ts) == (0, 0, w, h):
        return mip_mask, None, (0, 0, w, h)

    sub = keep[ty0:ty1, tx0:tx1]
    bits = np.packbits(sub.reshape(-1).astype(np.uint8), bitorder="little")
    hdr = MipmapHeader(x=tx0, y=ty0, w=tx1 - tx0, h=ty1 - ty0,
                       stream_size=len(bits), version=1,
                       mipmap_level=tile_shift)
    return mip_mask, _chunk(b"MIPM", hdr.pack() + bits.tobytes()), \
        (tx0 * ts, ty0 * ts, tx1 * ts, ty1 * ts)


def _pack6(vals: np.ndarray) -> bytes:
    """Pack 6-bit values, 4 values -> 3 bytes (little-endian bit order)."""
    n = len(vals)
    pad = (-n) % 4
    v = np.concatenate([vals, np.zeros(pad, vals.dtype)]).reshape(-1, 4)
    v = v.astype(np.uint32)
    b0 = (v[:, 0] | (v[:, 1] << 6)) & 0xFF
    b1 = ((v[:, 1] >> 2) | (v[:, 2] << 4)) & 0xFF
    b2 = ((v[:, 2] >> 4) | (v[:, 3] << 2)) & 0xFF
    packed = np.stack([b0, b1, b2], axis=1).astype(np.uint8).reshape(-1)
    # trim bytes that carry no data (state-machine flush keeps partials)
    used_bits = n * 6
    return packed.tobytes()[: (used_bits + 7) // 8]


def process_alpha(alpha: np.ndarray, mip_mask: np.ndarray | None,
                  mip_bound: tuple, force_8bit: bool = True,
                  use_inverse: bool = True):
    """ProcessAlpha: classify + emit the ALPM chunk (or None)."""
    h, w = alpha.shape
    bx0, by0, bx1, by1 = mip_bound
    a = alpha.astype(np.int32)

    region = a[by0:by1, bx0:bx1]
    nz = np.argwhere((region >> 2) != 0)
    if nz.size == 0:
        return None  # all-zero (in 6-bit) alpha: no chunk
    (ry0, rx0), (ry1, rx1) = nz.min(axis=0), nz.max(axis=0)
    bl, bt = int(rx0) + bx0, int(ry0) + by0
    br, bb = int(rx1) + bx0 + 1, int(ry1) + by0 + 1
    bl = (bl >> 2) << 2
    br = ((br + 3) >> 2) << 2

    # classification scans only the aligned bbox region (reference loop
    # :1510-1560); outside pixels never influence the mode
    vals8 = a[bt:bb, bl:br]
    is_all1 = bool((vals8 == 255).all())
    is_all0 = bool((vals8 == 0).all())
    is_analog = bool(((vals8 != 255) & (vals8 != 0)).any())
    if is_all0 or is_all1:
        return None

    if not is_analog:
        # binary alpha: 1 bit per pixel over an 8-aligned bbox
        bl8 = (bl >> 3) << 3
        br8 = ((br + 7) >> 3) << 3
        bits = (a[bt:bb, bl8:br8] & 1).astype(np.uint8)
        raw = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
        params = AlphaHeader.IS_1_BIT_FULL
        bbox = (bl8, bt, br8 - bl8, bb - bt)
    elif force_8bit:
        raw = vals8.astype(np.uint8).tobytes()
        params = AlphaHeader.IS_8_BIT_FULL
        bbox = (bl, bt, br - bl, bb - bt)
    else:
        sparse = mip_mask is not None and not mip_mask.all()
        if sparse:
            sel = vals8[mip_mask[bt:bb, bl:br]]
            params = (AlphaHeader.IS_6_BIT_USEMIPMAPMASK_INVERSE if use_inverse
                      else AlphaHeader.IS_6_BIT_USEMIPMAPMASK)
        else:
            sel = vals8.reshape(-1)
            params = (AlphaHeader.IS_6_BIT_FULL_INVERSE if use_inverse
                      else AlphaHeader.IS_6_BIT_FULL)
        v6 = (sel >> 2).astype(np.uint8)
        if use_inverse:
            v6 = (63 - v6).astype(np.uint8)
        raw = _pack6(v6)
        bbox = (bl, bt, br - bl, bb - bt)

    z = _zstd_sweep(raw)
    profiler.count("alpm_in_bytes", len(raw))
    profiler.count("alpm_out_bytes", len(z))
    hdr = AlphaHeader(x=bbox[0], y=bbox[1], w=bbox[2], h=bbox[3],
                      stream_size=len(z), expected_decompression_size=len(raw),
                      version=1, parameters=params)
    return _chunk(b"ALPM", hdr.pack() + z)
