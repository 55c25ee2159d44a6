"""Public encode API of the port.

`encode_image(rgb, bank, device="cuda", config=None, bank2d=None,
engine="device")` encodes one RGB or RGBA image with all tile scoring on
`device` ("cuda", the default, for the hand kernels, "cpu" for their plain
versions): the device branch of
`yaik_tpu.encoder.context.encode_image(engine="device")`, byte for byte.
The device scores the RGB planes (the 7 gradient passes and the six 3D
passes); the host does the rest, as the JAX package's device engine does:
the MIPM / ALPM alpha chunks, and the passes the reference's Convert leaves
disabled when the config turns them on (UCOL, SMAP, the plane-subset
gradient passes, the 2D passes, PLNT), in Convert's order, then gradient
emission, the palette codec, 3D stream emission, the 1D residual, chunk mux
and zstd (its streams on one thread per core, `context._ZstdBatch.run`, as
the JAX package's YAIK_ZSTD_WORKERS; the same bytes). Every host module is
the port's copy of the JAX package's framework-neutral code
(`encoder/context.py`, `alpha.py`, `single_color.py`, `smooth_map.py`,
`gradient.py`, `corr2d.py`, `corr3d.py`, `plnt.py`, `palette_codec.py`,
`dyn1d.py`, `emit.py`, `native/`).

`engine="host"` scores on the host instead, as the JAX package's
`engine="host"` does: the gradient passes by `gradient.score_pass`, the
claims updated between passes, and the six 3D passes by `corr3d.run_pass`,
which writes their streams; everything else is the same emission. It
touches no tensor and no card (`device` plays no part), and it shares no
code with the scoring kernels, so its bytes are their oracle.
`score_image` and the batch entry points are device-only.

`bank` is a `bank.load_bank(dir)` (or the JAX package's `Bank`, which has
the same fields); `bank2d`, needed by `enable_2d` only, a
`bank2d.load_bank2d(dir)` (or the JAX package's `Bank2D`).
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from yaik_tpu_torch import native
from yaik_tpu_torch.decoder.engine import device_of, to_card
from yaik_tpu_torch.encoder import alpha as alphamod
from yaik_tpu_torch.encoder import bank as bankmod
from yaik_tpu_torch.encoder import (corr2d, corr3d, dyn1d, emit, gradient,
                                    pipeline, plnt, single_color, smooth_map,
                                    tables)
from yaik_tpu_torch.encoder.context import (EncoderConfig, _chunk,
                                            _gtil_deferred,
                                            _tile2d_chunk_deferred,
                                            _tile3d_chunk_deferred,
                                            _ZstdBatch)
from yaik_tpu_torch.encoder.palette_codec import (PaletteState,
                                                  palette_compress)
from yaik_tpu_torch.format import swizzle
from yaik_tpu_torch.format.headers import MAGIC, FileHeader, Header1D
from yaik_tpu_torch.utils import debug_dump, profiler

__all__ = ["EncoderConfig", "encode_image", "score_image", "emit_image"]


def _check(rgb: np.ndarray) -> None:
    if rgb.ndim != 3 or rgb.shape[2] not in (3, 4) or rgb.dtype != np.uint8:
        raise ValueError("expected an [h, w, 3] or [h, w, 4] u8 image")
    h, w = rgb.shape[:2]
    if (w & 7) or (h & 7):
        raise ValueError("image dimensions must be multiples of 8")


def _check_bank2d(cfg: EncoderConfig, bank2d) -> None:
    """The JAX package's refusal of `enable_2d` without a 2D bank, made
    before any scoring."""
    if cfg.enable_2d and bank2d is None:
        raise ValueError("enable_2d requires a bank2d (encoder/bank2d.py)")


def _planes(rgb: np.ndarray) -> np.ndarray:
    """[3, H, W] i32 RGB planes (an alpha channel is not scored)."""
    return rgb[:, :, :3].transpose(2, 0, 1).astype(np.int32)


def score_image(rgb: np.ndarray, bank: bankmod.Bank, device="cuda",
                config: EncoderConfig | None = None, plain: bool = False):
    """All tile scoring of one image's RGB planes on `device`: (the 7
    gradient accept grids, the six 3D passes' result dicts), as numpy
    arrays. `plain` scores every pass with the kernels' plain versions."""
    cfg = config or EncoderConfig()
    _check(rgb)
    dev = device_of(device)
    with profiler.stage("encode:upload"):
        planes = to_card(_planes(rgb), dev)
    claims = torch.zeros(planes.shape, dtype=torch.bool, device=dev)
    with profiler.stage("encode:gradient-scoring"):
        accepts = pipeline.run_gradient_scoring(planes, claims,
                                                cfg.reject_factor, plain)
    with profiler.stage("encode:3d-scoring"):
        t3 = pipeline.run_tile3d_scoring(planes, claims,
                                         tables.device_tables(bank, dev),
                                         plain)
    return accepts, t3


def host_gradient_accepts(rgb: np.ndarray, reject_factor: int = 3) -> list:
    """The 7 gradient passes' accept grids, scored on the host
    (`gradient.score_pass`), each pass's accepted tiles claimed before the
    next pass is scored, as the host engine's `gradient.run_pass` does."""
    planes = _planes(rgb)
    claims = np.zeros(planes.shape, bool)
    accepts = []
    for sx, sy in swizzle.GRADIENT_PASS_ORDER:
        accept = gradient.score_pass(planes, claims, sx, sy, reject_factor)
        gradient.claim_tiles(claims, accept, 1 << sy, 1 << sx, (0, 1, 2))
        accepts.append(accept)
    return accepts


def _alpha_chunks(rgb: np.ndarray, cfg: EncoderConfig, parts: list):
    """The MIPM and ALPM chunks of an RGBA image, appended to `parts`;
    returns (mip_mask or None, mip_bound) for the later passes."""
    h, w = rgb.shape[:2]
    mip_mask, mip_bound = None, (0, 0, w, h)
    if rgb.shape[2] != 4:
        return mip_mask, mip_bound
    alpha_plane = rgb[:, :, 3]
    if cfg.enable_mipmap:
        mip_mask, mip_chunk, mip_bound = alphamod.mip_prefilter(alpha_plane)
        if mip_chunk:
            parts.append(mip_chunk)
    if cfg.enable_alpha:
        alpm = alphamod.process_alpha(
            alpha_plane, mip_mask, mip_bound,
            force_8bit=cfg.alpha_force_8bit,
            use_inverse=cfg.alpha_use_inverse)
        if alpm:
            parts.append(alpm)
    return mip_mask, mip_bound


def emit_image(rgb: np.ndarray, accepts: list, t3: list | None,
               config: EncoderConfig | None = None,
               defer: _ZstdBatch | None = None, bank2d=None, bank=None):
    """The .yaik stream of an image from its scoring results (host only):
    the 7 gradient accept grids, and the six 3D passes' results, dense
    (`score_image`'s dicts) or compacted (`pipeline.unpack_compact`'s
    dicts of one image: shift, bits_scan, count, rows). With `t3=None` the
    3D passes are scored here on the host against `bank` (`corr3d.run_pass`,
    the host engine). The alpha chunks and the passes the config turns on
    run here, in the order of `yaik_tpu/encoder/context.py`'s
    `encode_image`.

    With `defer`, the image's streams queue on that shared zstd batch and
    a zero-argument maker of the bytes is returned: the caller runs the
    batch once for many images (the JAX package's `_defer`)."""
    cfg = config or EncoderConfig()
    _check(rgb)
    _check_bank2d(cfg, bank2d)
    h, w = rgb.shape[:2]
    planes = _planes(rgb)                                         # [3, H, W]
    parts: list = [FileHeader(MAGIC, 1, w, h, int(rgb.shape[2] == 4)).pack()]
    zb = _ZstdBatch() if defer is None else defer
    use_native = native.available()
    pal_state = native.NativePaletteState() if use_native else PaletteState()
    compress_palette = (native.palette_compress if use_native
                        else palette_compress)

    def gtil(bitmap, rgb_stream, sx, sy, plane, bbox=None):
        cust = compress_palette(rgb_stream, pal_state)
        if cust is None:
            raise RuntimeError("palette compression failed")
        parts.append(_gtil_deferred(zb, bitmap, cust, len(rgb_stream),
                                    cfg.color_compression_quad, sx, sy,
                                    plane, w, h, bbox=bbox))

    mip_mask, mip_bound = _alpha_chunks(rgb, cfg, parts)
    if cfg.enable_single_color:
        ucol, mip_after = single_color.single_color_out(
            planes, mip_mask, mip_bound, favor_accuracy=cfg.favor_accuracy)
        parts.append(ucol)
        if mip_mask is not None:
            mip_mask = mip_after
    if cfg.enable_smooth_map:
        smap, mip_after, _ = smooth_map.smooth_map(planes, mip_mask)
        parts.append(smap)
        if mip_mask is not None:
            mip_mask = mip_after

    # gradient passes: one shared 4x4 corner grid; claims defer to one
    # 4x4-block accumulator, expanded after the 3D passes. The native
    # emission keeps its own 4x4-grid mapped set; the plane-subset passes
    # read the full-resolution mapped_rgb, so with them on every pass
    # emits through it (the JAX package's path).
    with profiler.stage("encode:gradient"):
        claims = np.zeros((3, h, w), bool)                    # mapSmoothTile
        claims4 = np.zeros((h // 4, w // 4), bool)
        corners4 = gradient._corner_grids(planes, 4, 4).astype(np.int64)
        use_fast_emit = use_native and not cfg.enable_plane_gradients
        if use_fast_emit:
            corner_bytes = np.ascontiguousarray(gradient.compress_f(
                gradient.round6(corners4),
                cfg.color_compression_quad).astype(np.uint8))
            mapped4 = np.zeros((3, h // 4 + 1, w // 4 + 1), np.uint8)
        else:
            mapped_rgb = np.zeros((3, h + 1, w + 1), bool)    # mappedRGB
        for k, (sx, sy) in enumerate(swizzle.GRADIENT_PASS_ORDER):
            bbox = None
            if use_fast_emit:
                bitmap, rgb_stream, count, bbox = gradient.emit_pass_fast(
                    accepts[k], sx, sy, w, h, corner_bytes, mapped4, claims4)
            else:
                bitmap, rgb_stream, count = gradient.emit_pass(
                    planes, claims, mapped_rgb, accepts[k], sx, sy,
                    cfg.color_compression_quad, corners4=corners4,
                    claims4=claims4)
            if count and rgb_stream:
                gtil(bitmap, rgb_stream, sx, sy, 7, bbox)
    if debug_dump.enabled():    # the claim state after the gradient passes
        debug_dump.snapshot_accepts("gradient_claims4", claims4)

    # 3D LUT passes
    streams = _streams(w, h, swizzle.TILE3D_PASS_ORDER)
    if t3 is None:        # the host engine: each pass scores and emits
        claims |= np.repeat(np.repeat(claims4, 4, 0), 4, 1)[None]
        with profiler.stage("encode:3d-scoring"):
            for (sx, sy) in swizzle.TILE3D_PASS_ORDER:
                corr3d.run_pass(planes, claims, bank, sx, sy, streams)
        claims4 |= claims[0, ::4, ::4]
    else:
        _emit_tile3d(t3, w, h, streams, claims4)
    with profiler.stage("encode:3d-chunk"):
        parts.append(_tile3d_chunk_deferred(streams, cfg, w, h, zb))
    if claims4.any():
        claims |= np.repeat(np.repeat(claims4, 4, 0), 4, 1)[None]
    if debug_dump.enabled():
        debug_dump.snapshot_accepts("tile3d_claims4", claims4)

    def plane_gradient(mask):
        bitmap, rgb_stream, count = gradient.run_pass(
            planes, claims, mapped_rgb, 2, 2, cfg.reject_factor,
            cfg.color_compression_quad, plane_mask=mask)
        if count and rgb_stream:
            gtil(bitmap, rgb_stream, 2, 2, mask)

    if cfg.enable_plane_gradients:
        for mask in (5, 3, 6):           # RB, RG, GB (Convert :9260-9290)
            plane_gradient(mask)
    if cfg.enable_2d:                    # RG, GB, RB (Convert :9300-9382)
        for plane_mode in (0, 1, 2):
            streams2 = _streams(w, h, ((3, 3), (2, 2)))
            with profiler.stage("encode:2d-scoring"):
                corr2d.run_pass(planes, claims, bank2d, plane_mode, 3, 3,
                                streams2)
                corr2d.run_pass(planes, claims, bank2d, plane_mode, 2, 2,
                                streams2)
            parts.append(_tile2d_chunk_deferred(
                streams2, cfg, w, h, corr2d.COMPONENT[plane_mode], zb))
    if cfg.enable_plane_gradients:
        for mask in (1, 2, 4):           # R, G, B (Convert :9392-9420)
            plane_gradient(mask)

    with profiler.stage("encode:1d"):       # the 1D residual
        pix_stream, type_stream = bytearray(), bytearray()
        for p in range(3):
            if use_native:
                pix, typ = native.dyn1d_plane(
                    planes[p].astype(np.uint8), claims[p],
                    cfg.color_compression_1d, cfg.range_compression_1d)
                pix_stream += pix
                type_stream += typ
            else:
                dyn1d.run_plane(planes[p], claims[p], pix_stream,
                                type_stream, cfg.color_compression_1d,
                                cfg.range_compression_1d)
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

    if cfg.enable_plnt:        # after the 1D pass (Convert :9539-9545)
        parts.append(plnt.encode_plnt(planes, mip_mask, mip_bound))
    parts.append(struct.pack("<I", 0xDEADBEEF))

    def assemble() -> bytes:
        return b"".join(p if isinstance(p, bytes) else p() for p in parts)
    if defer is not None:
        return assemble
    with profiler.stage("encode:zstd-flush"):
        zb.run()
        return assemble()


def _emit_tile3d(t3: list, w: int, h: int, streams: dict,
                 claims4: np.ndarray) -> None:
    """The six 3D passes' streams from their device results, dense or
    compacted, and their accepted tiles ORed into `claims4`."""
    compact = "bits_scan" in t3[0]
    with profiler.stage("encode:3d-emit"):
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


def _streams(w: int, h: int, keys) -> dict:
    """Empty LUT-pass streams with a tile map per (sx, sy) in `keys`."""
    return {"color": bytearray(), "type": [],
            3: bytearray(), 4: bytearray(), 5: bytearray(), 6: bytearray(),
            "maps": {key: np.zeros(swizzle.bitmap_size_bytes(*key, w, h) * 8,
                                   np.uint8) for key in keys}}


def encode_image(rgb: np.ndarray, bank: bankmod.Bank, device="cuda",
                 config: EncoderConfig | None = None, bank2d=None,
                 engine: str = "device") -> bytes:
    """Encode an [h, w, 3|4] u8 image (dims multiples of 8), scoring on
    `device`, or on the host with `engine="host"`; returns the .yaik bytes.
    `bank2d` serves `enable_2d`."""
    cfg = config or EncoderConfig()
    _check(rgb)
    _check_bank2d(cfg, bank2d)
    if engine not in ("host", "device"):
        raise ValueError(f"unknown engine {engine!r}")
    with profiler.stage("encode:image"):
        if engine == "host":
            with profiler.stage("encode:gradient"):
                accepts = host_gradient_accepts(rgb, cfg.reject_factor)
            return emit_image(rgb, accepts, None, cfg, bank2d=bank2d,
                              bank=bank)
        accepts, t3 = score_image(rgb, bank, device, cfg)
        return emit_image(rgb, accepts, t3, cfg, bank2d=bank2d)
