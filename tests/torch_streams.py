"""Streams, images and operands the port's tests and chip_smoke.py build at
run time, from the port's own host modules: no jax and nothing of the JAX
package (tests/test_round3_fastpaths.py and tests/test_device_alpha.py,
which hold the originals, import both). tests/test_torch_families.py holds
these copies equal to the originals. Also the pixel digest of
tests/fixtures/port_digests.json, and the edge-shape crops of
tests/fixtures/edge_digests.json.
"""
from __future__ import annotations

import hashlib
import pathlib
import struct

import numpy as np

from yaik_tpu_torch.format import swizzle


def craft_t3_stream(w: int, h: int, overlap3: bool) -> bytes:
    """A valid .yaik whose 3DTL tiles overlap at the 4x4-block level: 16x8
    at (0, 0), 8x16 at (0, 0) [2 layers], and with overlap3 also 8x8 at
    (0, 0) [3 layers: no two-layer merge]. The copy of
    tests/test_round3_fastpaths.py's `_craft_t3_stream`."""
    from yaik_tpu_torch.encoder.context import (EncoderConfig, _ZstdBatch,
                                                _tile3d_chunk_deferred)
    from yaik_tpu_torch.format.headers import MAGIC, FileHeader

    rng = np.random.default_rng(42 + overlap3)
    streams = {
        "color": bytearray(), "type": [],
        3: bytearray(), 4: bytearray(), 5: bytearray(), 6: bytearray(),
        "maps": {key: np.zeros(swizzle.bitmap_size_bytes(*key, w, h) * 8,
                               np.uint8)
                 for key in swizzle.TILE3D_PASS_ORDER},
    }

    def add_tile(sx, sy, tx, ty, n_unclaimed_px):
        key = (sx, sy)
        txa, tya, valid = swizzle.tile_scan_coords(sx, sy, w, h)
        bits = np.zeros(txa.shape[0], bool)
        slot = np.flatnonzero(valid & (txa == tx) & (tya == ty))
        assert slot.size == 1
        bits[slot[0]] = True
        packed = np.frombuffer(swizzle.pack_bitmap(bits), np.uint8)
        streams["maps"][key][:len(packed)] |= packed
        mn = rng.integers(0, 100, 3)
        mx = mn + rng.integers(50, 120, 3)
        streams["color"] += bytes(np.concatenate([mn, mx]).astype(np.uint8))
        streams["type"].append(0 | (0 << 6) | (1 << 14))    # lut 0, 4-bit
        streams[4] += bytes(rng.integers(0, 16, n_unclaimed_px)
                            .astype(np.uint8))

    add_tile(4, 3, 0, 0, 128)     # 16x8: fully unclaimed
    add_tile(3, 4, 0, 0, 64)      # 8x16: top 8x8 claimed -> 4 free quads
    if overlap3:
        add_tile(3, 3, 0, 0, 0)   # 8x8: fully claimed -> 0 bytes, layer 3
    add_tile(3, 3, 3, 3, 64)

    body = bytearray()
    body += FileHeader(MAGIC, 1, w, h, 0).pack()
    zb = _ZstdBatch()
    chunk = _tile3d_chunk_deferred(streams, EncoderConfig(), w, h, zb)
    zb.run()
    body += chunk()
    body += struct.pack("<I", 0xDEADBEEF)
    return bytes(body)


# the five 64x64 RGBA cases of tests/test_device_alpha.py: name ->
# (EncoderConfig keywords, alpha of (yy, xx, rng))
ALPHA_CASES = {
    "8bit": (dict(),
             lambda yy, xx, r: r.integers(0, 256, (64, 64), np.uint8)),
    "6bit": (dict(alpha_force_8bit=False, enable_mipmap=False),
             lambda yy, xx, r: ((yy * 4 + xx) % 256).astype(np.uint8)),
    "1bit": (dict(),
             lambda yy, xx, r: np.where((yy // 8 + xx // 8) % 2 == 0,
                                        255, 0).astype(np.uint8)),
    "sparse": (dict(alpha_force_8bit=False),
               lambda yy, xx, r: np.where((yy >= 16) & (xx >= 16),
                                          (yy * 4) % 256, 0
                                          ).astype(np.uint8)),
    "const255": (dict(),
                 lambda yy, xx, r: np.full((64, 64), 255, np.uint8)),
}


def rgba_case(name: str) -> np.ndarray:
    """The [64, 64, 4] u8 image of alpha case `name` (seeded by its place
    in sorted order, so every run builds the same image)."""
    rng = np.random.default_rng(sorted(ALPHA_CASES).index(name))
    img = np.zeros((64, 64, 4), np.uint8)
    yy, xx = np.mgrid[0:64, 0:64]
    img[:, :, 0] = (yy * 3) & 0xFF
    img[:, :, 1] = (xx * 3) & 0xFF
    img[:, :, 2] = ((yy + xx) * 2) & 0xFF
    img[:, :, 3] = ALPHA_CASES[name][1](yy, xx, rng)
    return img


def synth_t2_pass(rng, mode: int, shift: tuple, nty: int, ntx: int,
                  accept: np.ndarray):
    """A random 2DTL pass plan (types, colours, idx | wmask<<6 bytes) with
    the given accept grid: the copy of tests/test_t2_merged.py's
    `_synth_pass`."""
    from yaik_tpu_torch.decoder import planner
    tw, th = 1 << shift[0], 1 << shift[1]
    g = nty * ntx
    types = ((rng.integers(0, 4, g) << 14)
             | rng.integers(0, 8, g)).astype(np.int64)
    colors = rng.integers(0, 256, (g, 4)).astype(np.uint8)
    packed = (rng.integers(0, 64, (g, th * tw))
              | (rng.integers(0, 2, (g, th * tw)) << 6)).astype(np.uint8)
    return planner.Tile2DPassPlan(mode=mode, shift=shift, accept=accept,
                                  types=types, colors=colors, packed=packed)


def d1_operands(rng, G: int) -> tuple:
    """Random 1D-residual operands in pack.pack_d1_blocks' layout, int32
    (prm [5, G], codes4 [12, G], wm2 [2, G]): packed colour0 and base
    bytes, d2 up to 21 bits, random code bytes (0 = colour0) and random
    write bits per (channel, pixel)."""
    c0, base = (rng.integers(0, 256, (3, G)) for _ in range(2))
    prm = np.stack([c0[0] | (c0[1] << 8) | (c0[2] << 16),
                    base[0] | (base[1] << 8) | (base[2] << 16),
                    *rng.integers(0, 1 << 21, (3, G))]).astype(np.uint32)
    words = rng.integers(0, 1 << 32, (14, G), dtype=np.uint64).astype(
        np.uint32)
    return tuple(np.ascontiguousarray(a).view(np.int32)
                 for a in (prm, words[:12], words[12:]))


def ramp_planes(rng, B: int, h: int, w: int) -> np.ndarray:
    """[B, 3, h, w] i32 gradient-stage operands: a seeded ramp per image and
    channel, broken by 0-2 noise pixels in each 16x16 block (its larger
    tiles fail in varied ways and smaller ones accept) and, where the image
    is wider than 16, by noise in its second 16x16 block of the top row:
    every gradient pass accepts some tiles and rejects others."""
    y, x = np.mgrid[0:h, 0:w]
    out = np.empty((B, 3, h, w), np.int32)
    for b in range(B):
        for c in range(3):
            out[b, c] = np.clip(np.round(
                rng.uniform(40, 200) + rng.uniform(-0.8, 0.8) * x
                + rng.uniform(-0.8, 0.8) * y), 0, 255)
        for by in range(0, h, 16):
            for bx in range(0, w, 16):
                for _ in range(int(rng.integers(0, 3))):
                    py = min(by + int(rng.integers(0, 16)), h - 1)
                    px = min(bx + int(rng.integers(0, 16)), w - 1)
                    out[b, :, py, px] = (out[b, :, py, px] + 60
                                         + rng.integers(0, 80, 3)) % 256
        block = out[b, :, :16, 16:32]
        block[:] = rng.integers(0, 256, block.shape)
    return out


def saturated_planes(h: int, w: int) -> np.ndarray:
    """[3, h, w] i32: 255 with 251 on every other 4-pixel lattice point. At
    reject factor 0 a 4x4 tile on a 255 origin passes by its round6p blend
    alone (round6p(251) = 255, and round6p clamps 255 at 255)."""
    y, x = np.mgrid[0:h, 0:w]
    odd = (y % 4 == 0) & (x % 4 == 0) & ((y // 4 + x // 4) % 2 == 1)
    return np.ascontiguousarray(np.broadcast_to(
        np.where(odd, 251, 255), (3, h, w)), np.int32)


def digest(pixels: np.ndarray) -> dict:
    """The shape and sha256 of a u8 pixel array, as
    tests/fixtures/port_digests.json holds them."""
    a = np.ascontiguousarray(pixels, np.uint8)
    return {"shape": list(a.shape), "sha256": hashlib.sha256(a).hexdigest()}


# the image sides no fixture has, as top-left crops of a fixture image:
# name -> (png, height, width). 16 px wide: the 16-wide 3D pass has one tile
# column. w % 16 == 8 (and h % 16 == 8): the last column of 16-wide tiles
# is half a tile, which no pass emits
EDGE_CROPS = {
    "img128_16x16": ("img128", 16, 16),
    "img128_24x16": ("img128", 24, 16),
    "img128_32x16": ("img128", 32, 16),
    "img128_128x16": ("img128", 128, 16),
    "sprite256_64x16": ("sprite256", 64, 16),
    "img128_128x120": ("img128", 128, 120),
    "img128_56x72": ("img128", 56, 72),
    "img128_64x24": ("img128", 64, 24),
    "sprite256_96x40": ("sprite256", 96, 40),
}


def crop(png: str, h: int, w: int) -> np.ndarray:
    """The top-left [h, w, 3|4] u8 crop of tests/fixtures/<png>.png."""
    from PIL import Image
    img = np.asarray(Image.open(pathlib.Path(__file__).parent / "fixtures"
                                / f"{png}.png"))
    return np.ascontiguousarray(img[:h, :w])


def edge_crop(name: str) -> np.ndarray:
    """The crop EDGE_CROPS names."""
    return crop(*EDGE_CROPS[name])
