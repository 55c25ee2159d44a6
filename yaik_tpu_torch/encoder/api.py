"""Public encode API of the port.

`encode_image(rgb, bank, device="cuda", config=None)` encodes one RGB
image with all tile scoring on `device` ("cuda", the default, for the hand
kernels, "cpu" for their plain versions): the device branch of
`yaik_tpu.encoder.context.encode_image(engine="device")`, whose streams
are byte-identical to the host engine's. The host side (gradient emission, palette codec, 3D stream
emission, the 1D residual, chunk mux and zstd) is the port's copy of the
JAX package's framework-neutral code (`encoder/context.py`,
`gradient.py`, `palette_codec.py`, `dyn1d.py`, `emit.py`, `native/`).
`bank` is a `bank.load_bank(dir)` (or the JAX package's `Bank`, which has
the same fields).

An RGBA image, or a config that turns on a pass the reference's Convert
leaves disabled (UCOL, SMAP, 2D, PLNT, plane gradients), raises
NotImplementedError; it is never handed to another engine.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from yaik_tpu_torch import native
from yaik_tpu_torch.decoder.engine import device_of
from yaik_tpu_torch.encoder import bank as bankmod
from yaik_tpu_torch.encoder import dyn1d, emit, gradient, pipeline, tables
from yaik_tpu_torch.encoder.context import (EncoderConfig, _chunk,
                                            _gtil_deferred,
                                            _tile3d_chunk_deferred,
                                            _ZstdBatch)
from yaik_tpu_torch.encoder.palette_codec import (PaletteState,
                                                  palette_compress)
from yaik_tpu_torch.format import swizzle
from yaik_tpu_torch.format.headers import MAGIC, FileHeader, Header1D

__all__ = ["EncoderConfig", "encode_image", "score_image", "emit_image"]

_DISABLED = ("enable_single_color", "enable_smooth_map", "enable_2d",
             "enable_plnt", "enable_plane_gradients")


def _check(rgb: np.ndarray, cfg: EncoderConfig) -> None:
    if rgb.ndim != 3 or rgb.shape[2] not in (3, 4) or rgb.dtype != np.uint8:
        raise ValueError("expected an [h, w, 3] u8 image")
    h, w = rgb.shape[:2]
    if (w & 7) or (h & 7):
        raise ValueError("image dimensions must be multiples of 8")
    if rgb.shape[2] == 4:
        raise NotImplementedError("RGBA encode is not ported yet (ROADMAP "
                                  "Queue 1)")
    on = [f for f in _DISABLED if getattr(cfg, f)]
    if on:
        raise NotImplementedError(f"{', '.join(on)}: passes the reference "
                                  "leaves disabled are not ported yet "
                                  "(ROADMAP Queue 1)")


def score_image(rgb: np.ndarray, bank: bankmod.Bank, device="cuda",
                config: EncoderConfig | None = None, plain: bool = False):
    """All tile scoring of one image on `device`: (the 7 gradient accept
    grids, the six 3D passes' result dicts), as numpy arrays. `plain`
    scores the 3D passes with the kernels' plain versions."""
    cfg = config or EncoderConfig()
    _check(rgb, cfg)
    dev = device_of(device)
    planes = torch.from_numpy(np.ascontiguousarray(
        rgb.transpose(2, 0, 1), np.int32)).to(dev)
    claims = torch.zeros(planes.shape, dtype=torch.bool, device=dev)
    accepts = pipeline.run_gradient_scoring(planes, claims,
                                            cfg.reject_factor)
    t3 = pipeline.run_tile3d_scoring(planes, claims,
                                     tables.device_tables(bank, dev), plain)
    return accepts, t3


def emit_image(rgb: np.ndarray, accepts: list, t3: list,
               config: EncoderConfig | None = None,
               defer: _ZstdBatch | None = None):
    """The .yaik stream of an image from its scoring results (host only):
    the 7 gradient accept grids, and the six 3D passes' results, dense
    (`score_image`'s dicts) or compacted (`pipeline.unpack_compact`'s
    dicts of one image: shift, bits_scan, count, rows).

    With `defer`, the image's streams queue on that shared zstd batch and
    a zero-argument maker of the bytes is returned: the caller runs the
    batch once for many images (the JAX package's `_defer`)."""
    cfg = config or EncoderConfig()
    _check(rgb, cfg)
    h, w = rgb.shape[:2]
    planes = rgb.transpose(2, 0, 1).astype(np.int32)             # [3, H, W]
    parts: list = [FileHeader(MAGIC, 1, w, h, 0).pack()]
    zb = _ZstdBatch() if defer is None else defer
    use_native = native.available()
    pal_state = native.NativePaletteState() if use_native else PaletteState()
    compress_palette = (native.palette_compress if use_native
                        else palette_compress)

    # gradient passes: one shared 4x4 corner grid; claims defer to one
    # 4x4-block accumulator, expanded after the 3D passes
    claims4 = np.zeros((h // 4, w // 4), bool)
    corners4 = gradient._corner_grids(planes, 4, 4).astype(np.int64)
    if use_native:
        corner_bytes = np.ascontiguousarray(gradient.compress_f(
            gradient.round6(corners4),
            cfg.color_compression_quad).astype(np.uint8))
        mapped4 = np.zeros((3, h // 4 + 1, w // 4 + 1), np.uint8)
    else:
        mapped_rgb = np.zeros((3, h + 1, w + 1), bool)
    for k, (sx, sy) in enumerate(swizzle.GRADIENT_PASS_ORDER):
        bbox = None
        if use_native:
            bitmap, rgb_stream, count, bbox = gradient.emit_pass_fast(
                accepts[k], sx, sy, w, h, corner_bytes, mapped4, claims4)
        else:
            bitmap, rgb_stream, count = gradient.emit_pass(
                planes, mapped_rgb, accepts[k], sx, sy,
                cfg.color_compression_quad, corners4, claims4)
        if count == 0 or not rgb_stream:
            continue
        cust = compress_palette(rgb_stream, pal_state)
        if cust is None:
            raise RuntimeError("palette compression failed")
        parts.append(_gtil_deferred(zb, bitmap, cust, len(rgb_stream),
                                    cfg.color_compression_quad, sx, sy, 7,
                                    w, h, bbox=bbox))

    # 3D LUT passes
    streams = {"color": bytearray(), "type": [],
               3: bytearray(), 4: bytearray(), 5: bytearray(), 6: bytearray(),
               "maps": {key: np.zeros(swizzle.bitmap_size_bytes(*key, w, h)
                                      * 8, np.uint8)
                        for key in swizzle.TILE3D_PASS_ORDER}}
    compact = "bits_scan" in t3[0]
    if compact:
        emit.emit_tile3d_streams_compact(t3, w, h, streams)
    else:
        emit.emit_tile3d_streams(t3, w, h, streams)
    for res in t3:
        sx, sy = res["shift"]
        tw, th = 1 << sx, 1 << sy
        if compact:       # the accept grid from the scan-order bits
            accept = np.zeros((h // th) * (w // tw), bool)
            accept[emit._scan_perm(sx, sy, w, h)[1]] = res["bits_scan"]
        else:
            accept = res["accept"]
        acc = accept.reshape(h // th, w // tw)
        claims4[: (h // th) * (th // 4), : (w // tw) * (tw // 4)] |= \
            np.repeat(np.repeat(acc, th // 4, 0), tw // 4, 1)
    parts.append(_tile3d_chunk_deferred(streams, cfg, w, h, zb))
    claims = np.repeat(np.repeat(claims4, 4, 0), 4, 1)

    # 1D residual
    pix_stream, type_stream = bytearray(), bytearray()
    for p in range(3):
        if use_native:
            pix, typ = native.dyn1d_plane(
                planes[p].astype(np.uint8), claims,
                cfg.color_compression_1d, cfg.range_compression_1d)
            pix_stream += pix
            type_stream += typ
        else:
            dyn1d.run_plane(planes[p], claims, pix_stream, type_stream,
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

    def assemble() -> bytes:
        return b"".join(p if isinstance(p, bytes) else p() for p in parts)
    if defer is not None:
        return assemble
    zb.run()
    return assemble()


def encode_image(rgb: np.ndarray, bank: bankmod.Bank, device="cuda",
                 config: EncoderConfig | None = None) -> bytes:
    """Encode an [h, w, 3] u8 image (dims multiples of 8) with the
    default passes, scoring on `device`; returns the .yaik bytes."""
    accepts, t3 = score_image(rgb, bank, device, config)
    return emit_image(rgb, accepts, t3, config)
