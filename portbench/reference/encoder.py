"""The plain host encoder: a frozen copy of the port's `engine="host"`
encode (`encoder/api.py`: `host_gradient_accepts` and `emit_image` with
`t3=None`) in its pure-Python form, the one the port takes when its native
library is absent: the gradient scorer and emission, the host 3D scorer,
the palette codec and the 1D residual in numpy and Python, and zstd-18.

It covers the passes the reference's Convert runs by default on an RGB
image (the seven gradient passes, the six 3D LUT passes, the 1D
residual), which is what every configuration of the benchmark states, and
an RGBA image's alpha chunks: MIPM and then ALPM ahead of the gradient
chunks, as the port's `emit_image` (`_alpha_chunks`) writes them under
`enable_mipmap`, `enable_alpha`, `alpha_force_8bit` and
`alpha_use_inverse` (`reference.alpha`). The RGB passes score the first
three channels alone, so an [h, w, 3] image gives the stream it always
gave. The passes the reference leaves disabled raise.
"""
from __future__ import annotations

import struct

import numpy as np

from portbench.reference import alpha, corr3d, dyn1d, gradient, swizzle
from portbench.reference.bank import Bank
from portbench.reference.context import (EncoderConfig, _chunk,
                                         _gtil_deferred,
                                         _tile3d_chunk_deferred, _ZstdBatch)
from portbench.reference.headers import MAGIC, FileHeader, Header1D
from portbench.reference.palette_codec import PaletteState, palette_compress

_OFF_BY_DEFAULT = ("enable_single_color", "enable_smooth_map",
                   "enable_plane_gradients", "enable_2d", "enable_plnt")


def _planes(rgb: np.ndarray) -> np.ndarray:
    return rgb[:, :, :3].transpose(2, 0, 1).astype(np.int32)


def gradient_accepts(planes: np.ndarray, reject_factor: int) -> list:
    """The 7 gradient passes' accept grids, each pass's accepted tiles
    claimed before the next pass is scored."""
    claims = np.zeros(planes.shape, bool)
    accepts = []
    for sx, sy in swizzle.GRADIENT_PASS_ORDER:
        accept = gradient.score_pass(planes, claims, sx, sy, reject_factor)
        gradient.claim_tiles(claims, accept, 1 << sy, 1 << sx, (0, 1, 2))
        accepts.append(accept)
    return accepts


def _streams(w: int, h: int, keys) -> dict:
    return {"color": bytearray(), "type": [],
            3: bytearray(), 4: bytearray(), 5: bytearray(), 6: bytearray(),
            "maps": {key: np.zeros(swizzle.bitmap_size_bytes(*key, w, h) * 8,
                                   np.uint8) for key in keys}}


def _alpha_chunks(alpha_plane: np.ndarray, cfg: EncoderConfig,
                  parts: list) -> None:
    """An RGBA image's MIPM and ALPM chunks, appended to `parts`."""
    h, w = alpha_plane.shape
    mip_mask, mip_bound = None, (0, 0, w, h)
    if cfg.enable_mipmap:
        mip_mask, mip_chunk, mip_bound = alpha.mip_prefilter(alpha_plane)
        if mip_chunk:
            parts.append(mip_chunk)
    if cfg.enable_alpha:
        alpm = alpha.process_alpha(alpha_plane, mip_mask, mip_bound,
                                   force_8bit=cfg.alpha_force_8bit,
                                   use_inverse=cfg.alpha_use_inverse)
        if alpm:
            parts.append(alpm)


def encode_image(rgb: np.ndarray, bank: Bank,
                 config: EncoderConfig | None = None) -> bytes:
    """The .yaik stream of an [h, w, 3] or [h, w, 4] u8 image (sides
    multiples of 8)."""
    cfg = config or EncoderConfig()
    if rgb.ndim != 3 or rgb.shape[2] not in (3, 4) or rgb.dtype != np.uint8:
        raise ValueError("the frozen encoder takes [h, w, 3] or [h, w, 4] "
                         "u8 images")
    h, w = rgb.shape[:2]
    if (w & 7) or (h & 7):
        raise ValueError("image dimensions must be multiples of 8")
    if any(getattr(cfg, k) for k in _OFF_BY_DEFAULT):
        raise ValueError("the frozen encoder runs the default passes only")
    planes = _planes(rgb)
    accepts = gradient_accepts(planes, cfg.reject_factor)
    parts: list = [FileHeader(MAGIC, 1, w, h, int(rgb.shape[2] == 4)).pack()]
    if rgb.shape[2] == 4:
        _alpha_chunks(rgb[:, :, 3], cfg, parts)
    zb = _ZstdBatch()
    pal_state = PaletteState()

    claims = np.zeros((3, h, w), bool)
    claims4 = np.zeros((h // 4, w // 4), bool)
    corners4 = gradient._corner_grids(planes, 4, 4).astype(np.int64)
    mapped_rgb = np.zeros((3, h + 1, w + 1), bool)
    for k, (sx, sy) in enumerate(swizzle.GRADIENT_PASS_ORDER):
        bitmap, rgb_stream, count = gradient.emit_pass(
            planes, claims, mapped_rgb, accepts[k], sx, sy,
            cfg.color_compression_quad, corners4=corners4, claims4=claims4)
        if count and rgb_stream:
            cust = palette_compress(rgb_stream, pal_state)
            if cust is None:
                raise RuntimeError("palette compression failed")
            parts.append(_gtil_deferred(zb, bitmap, cust, len(rgb_stream),
                                        cfg.color_compression_quad, sx, sy,
                                        7, w, h))

    streams = _streams(w, h, swizzle.TILE3D_PASS_ORDER)
    claims |= np.repeat(np.repeat(claims4, 4, 0), 4, 1)[None]
    for sx, sy in swizzle.TILE3D_PASS_ORDER:
        corr3d.run_pass(planes, claims, bank, sx, sy, streams)
    claims4 |= claims[0, ::4, ::4]
    parts.append(_tile3d_chunk_deferred(streams, cfg, w, h, zb))
    if claims4.any():
        claims |= np.repeat(np.repeat(claims4, 4, 0), 4, 1)[None]

    pix_stream, type_stream = bytearray(), bytearray()
    for p in range(3):
        dyn1d.run_plane(planes[p], claims[p], pix_stream, type_stream,
                        cfg.color_compression_1d, cfg.range_compression_1d)
    if pix_stream:
        h_pix = zb.add(bytes(pix_stream), 18, len(pix_stream) * 2)
        h_typ = zb.add(bytes(type_stream), 18, len(pix_stream))

        def mk_1d(n_pix=len(pix_stream), n_typ=len(type_stream)):
            z_pix, z_type = zb.get(h_pix), zb.get(h_typ)
            hdr = Header1D(
                stream_pixel_bit=len(z_pix), stream_pixel_uncmp=n_pix,
                stream_type_cnt=len(z_type), stream_type_uncmp=n_typ,
                compression_color=cfg.color_compression_1d,
                compression_range=cfg.range_compression_1d, version=0)
            return _chunk(b"1DTL", hdr.pack() + z_type + z_pix)
        parts.append(mk_1d)
    parts.append(struct.pack("<I", 0xDEADBEEF))
    zb.run()
    return b"".join(p if isinstance(p, bytes) else p() for p in parts)
