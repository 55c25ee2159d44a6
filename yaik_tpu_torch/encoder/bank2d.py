"""2D-LUT bank: load Bank2D pattern PNGs, build EvalCtx2D tables, write
LutFile2D.lut.

The port's copy of `yaik_tpu/encoder/bank2d.py`.

Mirrors the reference's disabled 2D path: Load2DPattern
(EncoderContext.cpp:7935-8032), sortPalette2D (:2962, Morton selection
sort), EvalCtx2D::Set2DPointCloud (EncoderContext.h:463-526) and
BinarySave2D (:5502) / the RegisterAndCreate2DLut LutFile2D writer
(:8070-8095).

Reference quirks preserved:
- factors are the RAW 0..63 point coordinates - unlike the 3D path, which
  scales by 128/63 (Set3DPointCloud :4750). The decoder divides by 128
  either way, so 2D reconstruction systematically shrinks toward the bbox
  minimum; only low-dynamic tiles pass the error gate. This is the
  reference's behavior, not ours to fix (stream parity).
- the scoring distance field is the 3-bit subset's (per-step overwrite in
  Set2DPointCloud, step 3 last).
- computeValues2D indexes the 3-bit factor tables with 4-BIT map indices
  (:5641 uses GetValue4Bit2D for idx3Bit), overrunning xFactor3Bit[8] into
  yFactor3Bit and yFactor3Bit into the zero-initialized tFactor3Bit; the
  extended arrays below reproduce the exact struct-layout reads
  (EncoderContext.h:409-411).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from yaik_tpu_torch.encoder.bank import _MX, _MY
from yaik_tpu_torch.format.headers import LUTHeader

FACTOR = 128


def sort_palette_morton_2d(xy: np.ndarray) -> np.ndarray:
    """sortPalette2D: ascending by encode2D(a, b) = morton256_x[a] |
    morton256_y[b] (:2915). Points are distinct pixels, so codes are unique
    and a plain argsort is exact."""
    codes = _MX[xy[:, 0]] | _MY[xy[:, 1]]
    return xy[np.argsort(codes, kind="stable")]


@dataclass
class EvalCtx2D:
    factors: dict       # bit -> [2**bit, 2] int16 raw coords (x, y)
    factors_ext3: np.ndarray  # [16, 2]: the OOB 3-bit read emulation
    position: dict      # bit -> [64, 64] int32 map, indexed [y, x]
    dist_field: np.ndarray    # i32 [64, 64] (3-bit subset), indexed [y, x]
    points: np.ndarray


def build_eval_ctx2d(points: np.ndarray) -> EvalCtx2D:
    """Set2DPointCloud. points: u8 [n, 2] morton-sorted, exactly the loaded
    count (tables beyond it stay zero, matching fresh-heap reads)."""
    factors = {}
    for bit, step in ((6, 1), (5, 2), (4, 4), (3, 8)):
        tab = np.zeros((1 << bit, 2), np.int16)
        sel = points[::step].astype(np.int16)
        tab[: len(sel)] = sel
        factors[bit] = tab
    # xFactor3Bit[8..15] reads yFactor3Bit[0..7]; yFactor3Bit[8..15] reads
    # tFactor3Bit (float[8], zero) reinterpreted as s16 -> zeros.
    ext = np.zeros((16, 2), np.int16)
    ext[:8] = factors[3][:8]
    ext[8:16, 0] = factors[3][:8, 1]
    # ext[8:16, 1] stays 0
    g = np.arange(64)
    yy, xx = np.meshgrid(g, g, indexing="ij")
    coords = np.stack([xx, yy], axis=-1).reshape(-1, 2).astype(np.int64)
    position = {}
    dist_field = None
    for bit, step in ((6, 1), (5, 2), (4, 4), (3, 8)):
        pts = points[::step].astype(np.int64)
        d = ((coords[:, None, :] - pts[None, :, :]) ** 2).sum(axis=2)
        idx = d.argmin(axis=1)     # strict < upstream -> first min wins
        position[bit] = idx.astype(np.int32).reshape(64, 64)
        dist_field = d[np.arange(len(coords)), idx].astype(np.int32)
    return EvalCtx2D(factors=factors, factors_ext3=ext, position=position,
                     dist_field=dist_field.reshape(64, 64), points=points)


def load_pattern_png(path: str) -> np.ndarray | None:
    """Load2DPattern PNG branch: first <=64 pixels (row-major scan) with a
    nonzero R channel become (x, y) points. The reference computes the pixel
    index with a hardcoded 64 stride (:7957), so only 64-wide PNGs are
    well-defined; we require them."""
    from PIL import Image
    if not os.path.exists(path):
        return None
    img = np.asarray(Image.open(path).convert("RGB"))
    if img.shape[1] != 64:
        raise ValueError("Bank2D patterns must be 64 px wide")
    ys, xs = np.nonzero(img[:, :, 0])
    pts = np.stack([xs, ys], axis=1).astype(np.uint8)[:64]
    return sort_palette_morton_2d(pts)


@dataclass
class Bank2D:
    ctxs: list
    points: list

    @property
    def count(self):
        return len(self.ctxs)


def load_bank2d(bank_dir: str) -> Bank2D:
    """Load Bank2D/*.lut.png in sorted filename order (the reference
    harness tools/ref_encode_2d_main.cpp uses the same order)."""
    ctxs, pts = [], []
    for name in sorted(os.listdir(bank_dir)):
        if not name.endswith(".png"):
            continue
        p = load_pattern_png(os.path.join(bank_dir, name))
        if p is not None and len(p):
            ctxs.append(build_eval_ctx2d(p))
            pts.append(p)
    return Bank2D(ctxs=ctxs, points=pts)


def write_lut2d_file(bank: Bank2D) -> bytes:
    """LutFile2D.lut: LUTHeader('LU20') + per bit 3..6, per pattern,
    x[len] + y[len] u8 (RegisterAndCreate2DLut :8070-8095; pad byte 0 is 1
    per the reference's double-assignment typo, pad byte 1 zero)."""
    out = bytearray()
    hdr = LUTHeader(tag=b"LU20", version=0, entry_count=bank.count - 1)
    out += hdr.pack()
    out[6] = 1   # padding_extension[0] = 1
    for bit in (3, 4, 5, 6):
        for ctx in bank.ctxs:
            f = ctx.factors[bit]
            out += f[:, 0].astype(np.uint8).tobytes()
            out += f[:, 1].astype(np.uint8).tobytes()
    return bytes(out)
