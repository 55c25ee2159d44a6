"""3D-LUT bank: load point-cloud files, build evaluation contexts.

A frozen copy of the port's `encoder/bank.py`. Mirrors reference
`EncoderContext.cpp`: Load3DPattern (:7851-7934, file format u8 count +
r/g/b arrays, Morton selection-sort via sortPalette :2920, reduceArray
:4675 when >64 pts), EvalCtx3D::Set3DPointCloud (:4744-4815: factor tables
= trunc((pt/63f)*128), per-bit-depth nearest-point index maps over the 64^3
cube with first-point-wins ties), and RegisterAndCreate3DLut (:7680-7849:
the 22 hardcoded bank file names + LutFile.lut writer).

The device scoring (`encoder/tables.py`) reads each LUT's points and factor
tables only: it measures distances to the points themselves. The index maps
and the distance field serve the host 3D scorer (`encoder/corr3d.py`) and
`ops/segments.py`, so an `EvalCtx3D` builds them when first asked and keeps
them: `load_bank` costs the device path nothing for them.

Note the reference's distance-field quirk: the field is rebuilt per bit
level 6,5,4,3 in that order into ONE array, so the surviving distanceField3D
used by the 48-pattern scoring is the 3-bit (8-point) one.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from portbench.reference.headers import LUTHeader

FACTOR = 128

# The reference encoder loads exactly these names from Bank3D/
# (EncoderContext.cpp:7796-7819); missing files are silently skipped.
BANK_FILE_NAMES = [
    "tileMap_Aqours_31107015_n_2250p.png_352-1416.lut",
    "tileMap_Aqours_41107010_2250p.png_1000-112.lut",
    "tileMap_Aqours_41107010_2250p.png_1000-504.lut",
    "tileMap_Aqours_43104009_r_2250p.png_1520-1968.lut",
    "tileMap_Aqours_43104009_r_2250p.png_1520-1976.lut",
    "tileMap_Aqours_43104009_r_2250p.png_1520-800.lut",
    "tileMap_Aqours_43104009_r_2250p.png_1568-2104.lut",
    "tileMap_Aqours_43104009_r_2250p.png_280-888.lut",
    "tileMap_Aqours_43104009_r_2250p.png_352-840.lut",
    "tileMap_Aqours_43104009_r_2250p.png_448-2088.lut",
    "tileMap_Aqours_43104009_r_2250p.png_464-1632.lut",
    "tileMap_Aqours_43104009_r_2250p.png_608-2152.lut",
    "tileMap_Aqours_43104009_r_2250p.png_688-2184.lut",
    "tileMap_Aqours_43104009_r_2250p.png_768-2176.lut",
    "tileMap_Aqours_43104009_r_2250p.png_88-280.lut",
    "tileMap_Aqours_43104009_r_720p.png_384-280.lut",
    "tileMap_Aqours_31107015_n_2250p.png_1128-104.lut",
    "tileMap_Aqours_41107010_2250p.png_1304-2040.lut",
    "tileMap_Aqours_41107010_2250p.png_1384-2208.lut",
    "tileMap_Aqours_31107015_n_2250p.png_1136-64.lut",
    "tileMap_Aqours_41109006_n_2250p.png_2528-528.lut",
    "tileMap_Aqours_41109006_r2550p.png_1296-752.lut",
]


def _morton_tables():
    """Standard 3D Morton interleave tables (morton256_x/y/z)."""
    v = np.arange(256, dtype=np.uint64)
    def spread(x):
        x = x & 0xFF
        r = np.zeros_like(x)
        for bit in range(8):
            r |= ((x >> bit) & 1) << (3 * bit)
        return r
    sx = spread(v)
    return sx, sx << 1, sx << 2


_MX, _MY, _MZ = _morton_tables()


def morton_encode(r, g, b):
    return _MX[r] | _MY[g] | _MZ[b]


def sort_palette_morton(xyz: np.ndarray) -> np.ndarray:
    """Selection sort ascending by Morton code (sortPalette :2920).
    Selection-sort with strict > keeps the FIRST minimum -> equivalent to a
    stable ascending sort by code."""
    codes = morton_encode(xyz[:, 0], xyz[:, 1], xyz[:, 2])
    order = np.argsort(codes, kind="stable")
    return xyz[order]


def reduce_array(xyz: np.ndarray, count_out: int) -> np.ndarray:
    """reduceArray (:4675): bucket-average countIn points into countOut."""
    count_in = len(xyz)
    out = np.zeros((count_out, 3), np.uint8)
    buckets = (np.arange(count_in) * count_out) // count_in
    for b in range(count_out):
        sel = xyz[buckets == b].astype(np.int64)
        out[b] = sel.sum(axis=0) // len(sel)
    return out


@dataclass(eq=False)
class EvalCtx3D:
    """One LUT table's evaluation context (EvalCtx3D, EncoderContext.h:592).

    factors: bit depth -> s16 [2**bit, 3] values 0..128. `position` (bit
    depth -> i32 [64, 64, 64] nearest-point index map, [z, y, x]) and
    `dist_field` (i32 [64**3] flat, x + y*64 + z*4096) come from `maps`
    when given, else from `points` at their first read."""
    factors: dict
    points: np.ndarray | None = None   # u8 [n, 3] cloud the maps come from
    maps: tuple | None = None          # (position, dist_field)

    def _maps(self) -> tuple:
        if self.maps is None:
            self.maps = nearest_maps(self.points)
        return self.maps

    @property
    def position(self) -> dict:
        return self._maps()[0]

    @property
    def dist_field(self) -> np.ndarray:
        return self._maps()[1]


def build_eval_ctx(points: np.ndarray) -> EvalCtx3D:
    """Set3DPointCloud (:4744). points: u8 [n,3] values 0..63
    (morton-sorted). The factor tables now, the maps at first use."""
    factors = {}
    for bit, step in ((6, 1), (5, 2), (4, 4), (3, 8)):
        tab = np.zeros((1 << bit, 3), np.int16)
        sel = points[::step].astype(np.float32)
        # trunc((v/63f)*128f) in float32, like the C cast to s16
        vals = ((sel / np.float32(63.0)) * np.float32(FACTOR)).astype(np.int16)
        tab[: len(vals)] = vals
        factors[bit] = tab
    return EvalCtx3D(factors=factors, points=points)


def nearest_maps(points: np.ndarray) -> tuple:
    """Set3DPointCloud's nearest-point maps and distance field: (bit depth
    -> i32 [64, 64, 64] index map [z, y, x], i32 [64**3] 3-bit distance
    field). C iterates pts in order with strict < -> first (lowest-index)
    point wins ties. Distances expand to |c|^2 + |p|^2 - 2 c.p via one f32
    matmul: every term is an integer (dot products <= 3*63^2 = 11907,
    totals < 2^24), so f32 values and argmin ties are exact."""
    g = np.arange(64)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")  # [z,y,x]
    coords = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3).astype(np.float32)
    ptsf = points.astype(np.float32)
    d_full = ((coords ** 2).sum(1)[:, None] + (ptsf ** 2).sum(1)[None, :]
              - 2.0 * (coords @ ptsf.T))           # [v, n] exact integers
    position = {}
    dist_field = None
    for bit, step in ((6, 1), (5, 2), (4, 4), (3, 8)):
        d = d_full[:, ::step]
        idx = d.argmin(axis=1)  # first min wins ties (np argmin = first)
        position[bit] = idx.astype(np.int32).reshape(64, 64, 64)  # [z,y,x]
        dist_field = d[np.arange(d.shape[0]), idx].astype(np.int32)
    # the final field is the 3-bit one (reference overwrite quirk)
    return position, dist_field


def load_bank_file(path: str) -> np.ndarray | None:
    """Load3DPattern (:7851): returns morton-sorted point array or None."""
    if not os.path.exists(path):
        return None
    data = open(path, "rb").read()
    count = data[0]
    r = np.frombuffer(data, np.uint8, count, 1)
    g = np.frombuffer(data, np.uint8, count, 1 + count)
    b = np.frombuffer(data, np.uint8, count, 1 + 2 * count)
    xyz = np.stack([r, g, b], axis=1)
    xyz = sort_palette_morton(xyz)
    if count > 64:
        xyz = reduce_array(xyz, 64)
    return xyz


@dataclass
class Bank:
    ctxs: list          # list[EvalCtx3D]
    points: list        # list[np.ndarray] raw sorted clouds

    @property
    def count(self):
        return len(self.ctxs)


@lru_cache(maxsize=8)
def load_bank(bank_dir: str) -> Bank:
    """RegisterAndCreate3DLut's load phase (:7796-7819).

    Memoized per directory: the bank is a static artifact. Callers must
    treat the returned Bank as read-only.
    """
    ctxs, points = [], []
    for name in BANK_FILE_NAMES:
        pts = load_bank_file(os.path.join(bank_dir, name))
        if pts is not None:
            points.append(pts)
            ctxs.append(build_eval_ctx(pts))
    return Bank(ctxs=ctxs, points=points)
