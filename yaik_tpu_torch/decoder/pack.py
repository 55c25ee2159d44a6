"""Plan-time operand packing for the device decode (numpy).

`plan_to_args` turns a `planner.DecodePlan` into the
explicit `DecodeArgs` the torch engine uploads. Every branch of
`jax_engine.decode_core` has its operands here: all-plane GTIL gradients,
3DTL/3DTX LUT tiles (two merged priority layers, or six per-size passes),
the UCOL/SMAP overlay, plane-variant GTIL, 2DTL (two merged layers, or six
per-pass passes), the 1DTL residual and alpha; and, apart from the image
decode, the PLNT plane (`plnt_args`, the copy of
`jax_engine.plnt_device_args`).

Counterpart of the JAX engine's plan-time packers
(`yaik_tpu/decoder/jax_engine.py`: `lut_device_table`,
`lut2d_device_table(3)`, `t3_merge_plan`, `t2_merge_plan`, the merged
gradient `code4` build, `_pack_d1_blocks`, the overlay, plane-gradient and
alpha arguments of `plan_to_device_args`), with layouts chosen for the
Hopper kernels rather than for Mosaic:

- gradient corners stay on the shared 4-px corner grid, packed
  `c0 | c1<<8 | c2<<16` per corner: the kernel indexes them directly, so
  there is no per-pass compact layout and no width gate;
- LUT tiles carry the FULL table row of each tile or 4x4 block: the kernels
  read the whole `[C, 64]` table (768 KB for `LutFile.lut`, 288 KB for the
  tripled `LutFile2D.lut`, held in L2), so there is no <= 256-row
  dictionary, no uniq pass and no dictionary/gather split;
- 2DTL rows index the mode-shifted tripled table (`lut2d_table3`), so one
  kernel serves T3 and 2DTL alike: a tile's 3-bit channel mask `chm`
  (7 for T3, the mode's plane pair for 2DTL) says which channels it writes.

A batch of same-size streams packs each plan with the forms the whole batch
can share (`uniform_forms`, the counterpart of `parallel/batch.py`'s
`_common_t3_modes` and `_common_t2_merged`) and stacks them into one
`DecodeArgs` (`stack_args`, the counterpart of `_stack_args`), which the
engine decodes with one launch per kernel.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from yaik_tpu_torch.decoder import planner as plannermod
from yaik_tpu_torch.encoder.plnt import (curves_from, diff_range_decode,
                                         min_range_decode)
from yaik_tpu_torch.entropy import zstd_backend as zstd
from yaik_tpu_torch.format import swizzle
from yaik_tpu_torch.utils import profiler

GRAD_SHIFTS = tuple(swizzle.GRADIENT_PASS_ORDER)
T3_SHIFTS = tuple(swizzle.TILE3D_PASS_ORDER)
LUT_BITS = (3, 4, 5, 6)
# 2DTL passes in decode order: mode 0 (RG) 8x8, 4x4, mode 1 (GB), mode 2 (RB)
T2_ORDER = tuple((mode, shift) for mode in (0, 1, 2)
                 for shift in ((3, 3), (2, 2)))
# per mode: the 3-bit written-channel mask, and the 6 colour columns
# (min RGB, max RGB) as indices into a tile's (minA, minB, maxA, maxB, 0)
T2_CHMASK = (0b011, 0b110, 0b101)
T2_COLS = ((0, 1, 4, 2, 3, 4), (4, 0, 1, 4, 2, 3), (0, 4, 1, 2, 4, 3))
# plane-variant GTIL masks: the pairs apply before 2DTL, the singles after
PGRAD_PAIRS = (5, 3, 6)
PGRAD_SINGLES = (1, 2, 4)
FORMS = (None, "merged", "passes")


@dataclass(frozen=True)
class LutTable:
    """The global packed LUT table of one bank: `tab [C, 64] i32`, each
    entry `c0 | c1<<8 | c2<<16`, with the first row (`base`) and row count
    (`nrows`) of each bit depth 3, 4, 5, 6."""
    tab: np.ndarray
    base: np.ndarray       # [4] i64
    nrows: np.ndarray      # [4] i64


def lut_table(expanded: dict) -> LutTable:
    """Pack an expanded 3D LUT bank (`yaik_tpu.format.lut.expand_lut`) into
    one `[C, 64]` i32 table, rows of 2^bit entries zero-padded to 64
    (jax_engine.lut_device_table's layout)."""
    parts, base, nrows, off = [], np.zeros(4, np.int64), np.zeros(4, np.int64), 0
    for bi, bit in enumerate(LUT_BITS):
        t = expanded[bit].astype(np.int32)          # [n_b, 2^bit, 3]
        pad = np.zeros((t.shape[0], 64), np.int32)
        pad[:, : t.shape[1]] = t[:, :, 0] | (t[:, :, 1] << 8) | (
            t[:, :, 2] << 16)
        base[bi], nrows[bi] = off, t.shape[0]
        off += t.shape[0]
        parts.append(pad)
    return LutTable(np.concatenate(parts, axis=0), base, nrows)


def lut2d_table(expanded2d: dict) -> LutTable:
    """Pack an expanded 2D LUT bank (`expand_lut2d`) into one `[C2, 64]`
    i32 table, entries `c0 | c1<<8` (jax_engine.lut2d_device_table).

    Each row is the 128-byte WINDOW of the flat per-bit section that starts
    at the row, not a zero-padded block: 3-bit tiles index past their
    16-byte row into the next pattern's entries (the encoder's idx3Bit bug,
    EncoderContext.cpp:5642; the reference decoder reads on through its
    contiguous table, YAIK_3DTile.cpp:2255). 128 zero bytes close each
    section."""
    parts, base, nrows, off = [], np.zeros(4, np.int64), np.zeros(4, np.int64), 0
    for bi, bit in enumerate(LUT_BITS):
        t = expanded2d[bit]                          # [n, 2^bit, 2]
        n = t.shape[0]
        flat = np.concatenate([t.reshape(-1).astype(np.uint8),
                               np.zeros(128, np.uint8)])
        starts = np.arange(n) * (t.shape[1] * 2)
        win = flat[starts[:, None] + np.arange(128)].reshape(
            n, 64, 2).astype(np.int32)
        base[bi], nrows[bi] = off, n
        off += n
        parts.append(win[:, :, 0] | (win[:, :, 1] << 8))
    return LutTable(np.concatenate(parts, axis=0), base, nrows)


def lut2d_table3(lut2: LutTable) -> np.ndarray:
    """The mode-shifted TRIPLED 2D table `[3 * C2, 64]` i32: row
    `mode * C2 + r` is row r with its two value bytes moved to the mode's
    planes (RG: bytes 0, 1; GB: 1, 2; RB: 0, 2), as
    jax_engine.lut2d_device_table3."""
    t = lut2.tab
    return np.concatenate([t, t << 8, (t & 0xFF) | ((t >> 8) << 16)], axis=0)


def rows_full(types: np.ndarray, lut: LutTable) -> np.ndarray:
    """Full table row per tile of one T3 or 2DTL pass from its type words
    (the planner's type-word decode and clamp, YAIK_3DTile.cpp type words;
    jax_engine._t3_rows_full and _t2_rows_full): rows of `lut`, the 3D
    table or the untripled 2D one."""
    t = types.astype(np.int64) & 0xFFFF
    bi = (t >> 14) & 3
    comb = np.minimum(t & 0x3FFF, lut.nrows[bi] - 1)
    return (lut.base[bi] + comb).astype(np.int32)


def t2_cols(mode: int, colors: np.ndarray) -> np.ndarray:
    """A 2DTL pass's [g, 4] (minA, minB, maxA, maxB) colours -> [g, 6] u8
    min RGB, max RGB with the mode's unused channel 0."""
    c = np.concatenate([np.asarray(colors).astype(np.uint8),
                        np.zeros((len(colors), 1), np.uint8)], axis=1)
    return np.ascontiguousarray(c[:, list(T2_COLS[mode])])


@dataclass
class Layers:
    """Two priority layers of LUT tiles re-blocked onto the 4x4 grid (G4 =
    H/4 * W/4 blocks, row-major); layer 1 applies over layer 0.

    idx16 [2, G4, 16] u8: the raw idx | wmask<<6 byte of each pixel.
    cols [2, G4, 6] u8: min RGB, max RGB of the block's tile.
    accept [2, G4] u8: 0 where the layer holds no tile; else the tile's
        channel mask (1 for merged T3, whose kernel writes all channels;
        T2_CHMASK[mode] for merged 2DTL).
    rows [2, G4] i32: the tile's full table row (2DTL: into the tripled
        table).
    """
    idx16: np.ndarray
    cols: np.ndarray
    accept: np.ndarray
    rows: np.ndarray

    ARRAYS = ("idx16", "cols", "accept", "rows")
    ROW_FIRST = ARRAYS


@dataclass
class LutPass:
    """One tile-size pass of LUT tiles for `kernels.lut_pass`, tiles of
    `1 << sx` x `1 << sy` pixels on a `grid` = (nty, ntx) tile grid (g =
    nty * ntx, row-major).

    packed [g, th*tw] u8: raw idx | wmask<<6 per pixel, row-major in the
        tile.
    cols [g, 6] u8: min RGB, max RGB.
    chm [g] u8: channels the tile writes (0 = not accepted).
    rows [g] i32: full table row.
    """
    shift: tuple
    grid: tuple
    packed: np.ndarray
    cols: np.ndarray
    chm: np.ndarray
    rows: np.ndarray

    ARRAYS = ("packed", "cols", "chm", "rows")


@dataclass
class PlaneGrad:
    """One plane-variant 4x4 GTIL pass for `kernels.grad_plane`: its corner
    grid `corners [H/4+1, W/4+1]` i32 (packed as the all-plane passes';
    the engine puts it in the (2, 2) slot), and `code4 [H/4, W/4]` u8, the
    (2, 2) slot's code where the pass accepts a block, else 0."""
    corners: np.ndarray
    code4: np.ndarray

    ARRAYS = ("corners", "code4")


@dataclass
class AlphaArgs:
    """Alpha of an RGBA stream: `spec` = (mode, (x, y, w, h) bbox, mipmap
    spec (mw, mh, x0, y0, tile) or None), mode 0 for constant 255; `raw`
    u8 ALPM payload (zero-padded as the planner gives it), `mip` u8 MIPM
    tile bits (LSB first)."""
    spec: tuple
    raw: np.ndarray
    mip: np.ndarray

    ARRAYS = ("raw", "mip")


@dataclass
class DecodeArgs:
    """Device operands of one stream. `plan_to_args` fills it with numpy
    arrays; `map` gives the same record with every array converted (the
    engine uses it to upload to a torch device).

    corners [7, H/4+1, W/4+1] i32: each all-plane gradient pass's corner
        grid on the shared 4-px grid, packed c0 | c1<<8 | c2<<16 (zeros for
        absent passes), in GRADIENT_PASS_ORDER.
    code4 [H/4, W/4] u8: per 4x4 block, 1 + the index of the last gradient
        pass that covers it (later passes overwrite), 0 for none.
    idx16, cols, accept, rows: the two merged T3 layers (as `Layers`,
        accept 0/1), or all None when T3 takes the per-size passes.
    t3_passes: None, or the six T3 size passes as `LutPass` (None for a
        pass the stream lacks) in TILE3D_PASS_ORDER, chm = 7 * accept.
    d1_prm [5, G4], d1_codes4 [12, G4], d1_wm2 [2, G4] i32: the 1D residual
        pass in 4x4-block space (jax_engine._pack_d1_blocks' layout).
    overlay: None, or [H, W] i32: the UCOL/SMAP pixels packed
        r | g<<8 | b<<16 with bit 24 set where the overlay writes.
    pgrad: None, or six `PlaneGrad` slots (None where the stream has no
        pass of that plane mask), masks PGRAD_PAIRS then PGRAD_SINGLES.
    t2_layers: None, or the two merged 2DTL layers (`Layers` into the
        tripled 2D table).
    t2_passes: None, or the six 2DTL passes as `LutPass` (into the tripled
        table) in T2_ORDER.
    alpha: None, or `AlphaArgs` (the result then has 4 channels).
    batch: None for one stream; B for B streams stacked by `stack_args`.
        Every per-image array then has a batch axis: the first, except for
        the layered ones (`ROW_FIRST`: the merged layers [2, B, G4, ...]
        and the 1D operands [5 | 12 | 2, B, G4]), where it follows the
        layer or row axis, so the merged kernels see B * G4 blocks.
    """
    height: int
    width: int
    corners: np.ndarray
    code4: np.ndarray
    idx16: np.ndarray | None
    cols: np.ndarray | None
    accept: np.ndarray | None
    rows: np.ndarray | None
    d1_prm: np.ndarray
    d1_codes4: np.ndarray
    d1_wm2: np.ndarray
    t3_passes: tuple | None = None
    overlay: np.ndarray | None = None
    pgrad: tuple | None = None
    t2_layers: Layers | None = None
    t2_passes: tuple | None = None
    alpha: AlphaArgs | None = None
    batch: int | None = None

    ARRAYS = ("corners", "code4", "idx16", "cols", "accept", "rows",
              "d1_prm", "d1_codes4", "d1_wm2", "overlay")
    NESTED = ("t3_passes", "pgrad", "t2_layers", "t2_passes", "alpha")
    ROW_FIRST = ("idx16", "cols", "accept", "rows", "d1_prm", "d1_codes4",
                 "d1_wm2")

    def map(self, fn) -> "DecodeArgs":
        return map_arrays(self, fn)


def map_arrays(x, fn):
    """`x` (a record of this module, a tuple of them, or None) with `fn`
    applied to every array of every record inside it."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(map_arrays(e, fn) for e in x)
    fields = {f: fn(getattr(x, f)) for f in x.ARRAYS
              if getattr(x, f) is not None}
    for f in getattr(x, "NESTED", ()):
        fields[f] = map_arrays(getattr(x, f), fn)
    return dataclasses.replace(x, **fields)


def grad_operands(plan: plannermod.DecodePlan):
    """(corners [7, qh, qw] i32 packed, code4 [H/4, W/4] u8) of the
    all-plane gradient passes."""
    h, w = plan.height, plan.width
    qh, qw = h // 4 + 1, w // 4 + 1
    by_shift = {g.shift: g for g in plan.gradient if g.plane_mask == 7}
    corners = np.zeros((7, qh, qw), np.int32)
    accepts = []
    for k, shift in enumerate(GRAD_SHIFTS):
        g = by_shift.get(shift)
        if g is None:
            accepts.append(None)
            continue
        corners[k] = pack_rgb(g.corners)
        accepts.append(g.accept)
    return corners, code4_from_accepts(accepts, h, w)


def pack_rgb(c: np.ndarray) -> np.ndarray:
    """[..., 3] u8 (a corner grid, overlay pixels) -> [...] i32
    c0 | c1<<8 | c2<<16."""
    c = np.asarray(c).astype(np.int32)
    return c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)


def code4_from_accepts(accepts, h: int, w: int) -> np.ndarray:
    """Per-4x4-block winner code from the 7 gradient accept grids (None for
    an absent pass): later passes overwrite, in GRADIENT_PASS_ORDER.
    Raises ValueError for an accepted tile that reaches past the image."""
    code4 = np.zeros((h // 4, w // 4), np.uint8)
    for k, ((sx, sy), acc) in enumerate(zip(GRAD_SHIFTS, accepts)):
        if acc is None:
            continue
        tw, th = 1 << sx, 1 << sy
        inside = acc[: h // th, : w // tw]
        if int(acc.sum()) != int(inside.sum()):
            raise ValueError(f"gradient pass {(sx, sy)} accepts a tile "
                             "past the image edge")
        exp = np.repeat(np.repeat(inside, th // 4, 0), tw // 4, 1)
        code4[: exp.shape[0], : exp.shape[1]][exp] = k + 1
    return code4


def _merge_layers(h: int, w: int, passes) -> Layers | None:
    """Re-block the tiles of `passes` (in decode order; each (shift, accept
    [nty, ntx], packed [g, P], rows [g], cols [g, 6] u8, chm)) onto the
    uniform 4x4 grid as two priority layers: a block covered by tiles of k
    passes lands on layers 0..k-1 in pass order, so applying layer 1 over
    layer 0 reproduces the sequential passes. None when a block needs a
    third layer."""
    ntx4 = w // 4
    G4 = (h // 4) * ntx4
    count = np.zeros(G4, np.uint8)
    lay = Layers(np.zeros((2, G4, 16), np.uint8), np.zeros((2, G4, 6), np.uint8),
                 np.zeros((2, G4), np.uint8), np.zeros((2, G4), np.int32))
    for (sx, sy), accept, packed, rows, cols, chm in passes:
        ntx = accept.shape[1]
        ids = np.flatnonzero(accept.reshape(-1))
        if ids.size == 0:
            continue
        nsy, nsx = (1 << sy) // 4, (1 << sx) // 4
        ty, tx = ids // ntx, ids % ntx
        by = ty[:, None, None] * nsy + np.arange(nsy)[None, :, None]
        bx = tx[:, None, None] * nsx + np.arange(nsx)[None, None, :]
        g4 = (by * ntx4 + bx).reshape(-1)
        pk = packed[ids].reshape(-1, nsy, 4, nsx, 4).transpose(
            0, 1, 3, 2, 4).reshape(-1, 16)
        rows_sub = np.repeat(rows[ids], nsy * nsx)
        cols_sub = np.repeat(cols[ids], nsy * nsx, axis=0)
        cur = count[g4]
        if int(cur.max(initial=0)) >= 2:
            return None
        for L in range(2):
            sel = cur == L
            t = g4[sel]
            lay.accept[L, t] = chm
            lay.rows[L, t] = rows_sub[sel]
            lay.cols[L, t] = cols_sub[sel]
            lay.idx16[L, t] = pk[sel]
        count[g4] = cur + 1            # g4 is unique within one pass
    return lay


def t3_merge_layers(plan: plannermod.DecodePlan, lut: LutTable):
    """All Tile3D size passes as two priority layers on the 4x4 grid
    (jax_engine.t3_merge_plan with max_layers=2 and full table rows).
    Returns (idx16, cols, accept, rows), or None when a block needs a third
    layer."""
    by_shift = {p.shift: p for p in plan.tile3d}
    lay = _merge_layers(plan.height, plan.width, (
        (s, p.accept, p.packed, rows_full(p.types, lut),
         p.colors.astype(np.uint8), 1)
        for s in T3_SHIFTS if (p := by_shift.get(s)) is not None))
    return None if lay is None else (lay.idx16, lay.cols, lay.accept, lay.rows)


def t2_merge_layers(plan: plannermod.DecodePlan, lut2: LutTable
                    ) -> Layers | None:
    """All 2DTL passes as two priority layers on the 4x4 grid
    (jax_engine.t2_merge_plan with full rows into the tripled table): row
    `mode * C2 + row`, colours in the mode's arrangement, accept = the
    mode's channel mask. None when a block needs a third layer."""
    C2 = lut2.tab.shape[0]
    by_key = {(p.mode, p.shift): p for p in plan.tile2d}
    return _merge_layers(plan.height, plan.width, (
        (s, p.accept, p.packed, mode * C2 + rows_full(p.types, lut2),
         t2_cols(mode, p.colors), T2_CHMASK[mode])
        for mode, s in T2_ORDER if (p := by_key.get((mode, s))) is not None))


def t3_pass_operands(plan: plannermod.DecodePlan, lut: LutTable) -> tuple:
    """The six T3 size passes as `LutPass`es in TILE3D_PASS_ORDER (None for
    a pass the stream lacks): the legacy per-pass form of
    plan_to_device_args (:1388-1423), full rows, no dictionary."""
    by_shift = {p.shift: p for p in plan.tile3d}
    return tuple(
        None if (p := by_shift.get(s)) is None else LutPass(
            s, p.accept.shape, p.packed, p.colors.astype(np.uint8),
            p.accept.reshape(-1).astype(np.uint8) * 7, rows_full(p.types, lut))
        for s in T3_SHIFTS)


def t2_pass_operands(plan: plannermod.DecodePlan, lut2: LutTable) -> tuple:
    """The six 2DTL passes as `LutPass`es in T2_ORDER (None for a pass the
    stream lacks), on the tripled table: row `mode * C2 + row`, colours in
    the mode's arrangement, chm = the mode's channel mask where accepted.
    The table rows carry the mode's byte shift, which replaces
    jax_engine._t2_operands' per-pass table shifting."""
    C2 = lut2.tab.shape[0]
    by_key = {(p.mode, p.shift): p for p in plan.tile2d}
    return tuple(
        None if (p := by_key.get((mode, s))) is None else LutPass(
            s, p.accept.shape, p.packed, t2_cols(mode, p.colors),
            p.accept.reshape(-1).astype(np.uint8) * T2_CHMASK[mode],
            mode * C2 + rows_full(p.types, lut2))
        for mode, s in T2_ORDER)


def overlay_operands(plan: plannermod.DecodePlan) -> np.ndarray | None:
    """The UCOL/SMAP overlay as one [H, W] i32 word per pixel,
    r | g<<8 | b<<16 | written<<24, or None."""
    ov = plan.overlay
    if ov is None:
        return None
    return pack_rgb(ov.vals) | (ov.mask.astype(np.int32) << 24)


def pgrad_operands(plan: plannermod.DecodePlan) -> tuple | None:
    """The plane-variant GTIL passes (plane mask != 7) as six `PlaneGrad`
    slots, masks PGRAD_PAIRS then PGRAD_SINGLES (None for an absent mask),
    or None when the stream has none. Like the JAX engine, the last pass of
    each mask wins and every variant is a 4x4 pass (the only size the
    encoder emits; another raises ValueError)."""
    h, w = plan.height, plan.width
    variants = {g.plane_mask: g for g in plan.gradient if g.plane_mask != 7}
    if not variants:
        return None
    k22 = GRAD_SHIFTS.index((2, 2))
    slots = []
    for mask in PGRAD_PAIRS + PGRAD_SINGLES:
        g = variants.get(mask)
        if g is None:
            slots.append(None)
            continue
        if g.shift != (2, 2):
            raise ValueError(f"plane-variant GTIL pass of size {g.shift} "
                             "(only 4x4 variants are decoded)")
        accepts = [None] * len(GRAD_SHIFTS)
        accepts[k22] = g.accept
        slots.append(PlaneGrad(pack_rgb(g.corners),
                               code4_from_accepts(accepts, h, w)))
    return tuple(slots)


def alpha_spec(plan: plannermod.DecodePlan):
    """None (no alpha) or (mode, bbox, mip spec), as
    jax_engine.alpha_spec_of: mode 0 is the constant-255 fill of an RGBA
    stream without an ALPM chunk."""
    if not plan.has_alpha:
        return None
    ap = plan.alpha_plan
    if ap is None:
        return (0, (0, 0, plan.width, plan.height), None)
    mspec = None
    if ap.mip is not None:
        mw, mh = ap.mip.grid
        x0, y0 = ap.mip.origin
        mspec = (mw, mh, x0, y0, 1 << ap.mip.level)
    return (ap.mode, ap.bbox, mspec)


def alpha_operands(plan: plannermod.DecodePlan) -> AlphaArgs | None:
    """`AlphaArgs` of an RGBA stream, or None."""
    spec = alpha_spec(plan)
    if spec is None:
        return None
    ap = plan.alpha_plan
    raw = ap.raw if ap is not None else np.zeros(1, np.uint8)
    mip = (ap.mip.bits if ap is not None and ap.mip is not None
           else np.zeros(1, np.uint8))
    return AlphaArgs(spec, raw, mip)


def pack_d1_blocks(plan: plannermod.DecodePlan):
    """The 1D residual pass in 4x4-block space: (prm [5, G4], codes4
    [12, G4], wm2 [2, G4]) i32 - jax_engine._pack_d1_blocks' layout.
    Block (ty4, tx4) maps to 8x8 tile (ty4>>1, tx4>>1), quadrant
    (ty4&1, tx4&1).

    prm: color0 packed c0|c1<<8|c2<<16, base packed likewise, then delta2
    of each channel. codes4: channel c's index bytes in rows 4c..4c+3,
    byte j of row 4c+r is pixel 4r+j. wm2: the write bit of (channel c,
    pixel p) is bit (c*16+p) & 31 of row (c*16+p) >> 5."""
    h, w = plan.height, plan.width
    nty8, ntx8 = h // 8, w // 8
    G4 = (h // 4) * (w // 4)

    def to_blocks(a):             # [3, g8, 64] -> [3, G4, 16]
        b = a.reshape(3, nty8, ntx8, 2, 4, 2, 4)
        return np.ascontiguousarray(
            b.transpose(0, 1, 3, 2, 5, 4, 6)).reshape(3, G4, 16)

    cb = to_blocks(plan.d1.indices)                          # [3, G4, 16]
    codes4 = np.ascontiguousarray(
        cb.view("<u4").transpose(0, 2, 1)).reshape(12, G4).view(np.int32)
    wmb = to_blocks(plan.d1.wmask.astype(np.uint8))
    w16 = np.packbits(wmb, axis=-1, bitorder="little")       # [3, G4, 2]
    wbits = w16.view("<u2")[:, :, 0].astype(np.uint32)       # [3, G4]
    wm2 = np.ascontiguousarray(np.stack(
        [wbits[0] | (wbits[1] << 16), wbits[2]])).view(np.int32)
    pr = plan.d1.params.astype(np.uint32)                    # [3, g8, 3]
    pb = np.repeat(np.repeat(pr.reshape(3, nty8, ntx8, 3), 2, axis=1),
                   2, axis=2).reshape(3, G4, 3)
    prm = np.ascontiguousarray(np.stack([
        pb[0, :, 0] | (pb[1, :, 0] << 8) | (pb[2, :, 0] << 16),
        pb[0, :, 1] | (pb[1, :, 1] << 8) | (pb[2, :, 1] << 16),
        pb[0, :, 2], pb[1, :, 2], pb[2, :, 2]])).view(np.int32)
    return prm, codes4, wm2


def plan_to_args(plan: plannermod.DecodePlan, lut: LutTable,
                 lut2: LutTable | None = None, t3_form: str | None = None,
                 t2_form: str | None = None) -> DecodeArgs:
    """Pack a plan. `lut2` is the 2D bank's table (`lut2d_table`), needed
    by a stream with 2DTL passes (ValueError without it, as
    plan_to_device_args :1437).

    T3 and 2DTL each take the merged form (two priority layers, one
    launch) when their tiles merge onto two layers, else the six per-pass
    passes. `t3_form` / `t2_form` = "merged" or "passes" force a form (for
    holding the two against each other; the counterparts of
    plan_to_device_args' `t3_modes` and `t2_merged`); forcing "merged" on
    a plan that needs a third layer raises ValueError."""
    if plan.width % 8 or plan.height % 8:
        raise ValueError(f"image {plan.width}x{plan.height}: dimensions "
                         "must be multiples of 8")
    for name, form in (("t3_form", t3_form), ("t2_form", t2_form)):
        if form not in FORMS:
            raise ValueError(f"{name} must be one of {FORMS}, not {form!r}")
    with profiler.stage("decode:pack"):
        with profiler.stage("pack:gradient"):
            corners, code4 = grad_operands(plan)
        with profiler.stage("pack:t3"):
            layers = (None if t3_form == "passes"
                      else t3_merge_layers(plan, lut))
            if layers is None and t3_form == "merged":
                raise ValueError("merged T3 forced, but the tiles need a "
                                 "third priority layer")
            t3_passes = (t3_pass_operands(plan, lut) if layers is None
                         else None)
        idx16, cols, accept, rows = layers or (None,) * 4
        t2_layers = t2_passes = None
        with profiler.stage("pack:2dtl"):
            if plan.tile2d:
                if lut2 is None:
                    raise ValueError("plan carries 2DTL passes but no 2D "
                                     "LUT given")
                if t2_form != "passes":
                    t2_layers = t2_merge_layers(plan, lut2)
                if t2_layers is None and t2_form == "merged":
                    raise ValueError("merged 2DTL forced, but the tiles "
                                     "need a third priority layer")
                if t2_layers is None:
                    t2_passes = t2_pass_operands(plan, lut2)
        with profiler.stage("pack:d1"):
            prm, codes4, wm2 = pack_d1_blocks(plan)
        with profiler.stage("pack:extras"):
            overlay, pgrad = overlay_operands(plan), pgrad_operands(plan)
            alpha = alpha_operands(plan)
    return DecodeArgs(plan.height, plan.width, corners, code4, idx16, cols,
                      accept, rows, prm, codes4, wm2, t3_passes=t3_passes,
                      overlay=overlay, pgrad=pgrad, t2_layers=t2_layers,
                      t2_passes=t2_passes, alpha=alpha)


def uniform_forms(plans: list, args: list, lut: LutTable,
                  lut2: LutTable | None = None) -> list:
    """`args` (plan_to_args of each of `plans`, forms chosen per plan)
    with the forms a batch can share, as the JAX package's
    `_common_t3_modes` and `_common_t2_merged` choose them: T3 takes the
    merged layers when every plan merges onto two layers, else every plan
    takes the six passes; 2DTL likewise over the plans with 2DTL tiles.
    The merged 2DTL kernel runs on every device, so no device gates it. A
    plan whose form changes is packed anew."""
    t3 = "passes" if any(a.idx16 is None for a in args) else None
    t2 = "passes" if any(a.t2_passes is not None for a in args) else None
    return [plan_to_args(p, lut, lut2, t3_form=t3, t2_form=t2)
            if (t3 and a.idx16 is not None) or (t2 and a.t2_layers is not None)
            else a for p, a in zip(plans, args)]


def stack_args(args: list) -> DecodeArgs:
    """B `DecodeArgs` of same-size streams (numpy, one stream each) -> one
    batched `DecodeArgs` (`batch` = B). The streams must share one
    structure, as the JAX package's `_stack_args` requires of its pytrees:
    the same forms (`uniform_forms`), the same alpha spec, and an overlay,
    plane gradients and 2DTL operands in all of them or in none. A T3,
    2DTL or plane-gradient slot that some streams lack takes zero operands
    there (nothing accepted), as the JAX packer fills it. Raises ValueError
    naming the field where the structures differ."""
    if not args:
        raise ValueError("stack_args needs at least one DecodeArgs")
    if any(a.batch is not None for a in args):
        raise ValueError("stack_args takes unbatched DecodeArgs")
    return dataclasses.replace(_stack(args, "args"), batch=len(args))


def _stack(items: list, where: str):
    """The records (or tuples of records, or Nones) of `items`, one per
    stream, stacked along a new batch axis."""
    if all(x is None for x in items):
        return None
    i = next(i for i, x in enumerate(items) if x is not None)
    j = next((j for j, x in enumerate(items) if x is None), None)
    if j is not None:
        raise ValueError(f"cannot batch these streams: {where} is None in "
                         f"stream {j} and not in stream {i}")
    x0 = items[0]
    if isinstance(x0, tuple):
        if any(len(x) != len(x0) for x in items):
            raise ValueError(f"cannot batch these streams: {where} differs "
                             "in length")
        return tuple(_stack(_zero_filled([x[k] for x in items]),
                            f"{where}[{k}]") for k in range(len(x0)))
    out = {}
    for f in dataclasses.fields(x0):
        vals = [getattr(x, f.name) for x in items]
        name = f"{where}.{f.name}"
        if f.name in getattr(x0, "NESTED", ()):
            out[f.name] = _stack(vals, name)
        elif f.name in x0.ARRAYS:
            if all(v is None for v in vals):
                continue
            if any(v is None for v in vals):
                raise ValueError(f"cannot batch these streams: {name} is "
                                 "None in some streams and not in others")
            if any(v.shape != vals[0].shape for v in vals):
                raise ValueError(f"cannot batch these streams: {name} "
                                 "differs in shape")
            axis = 1 if f.name in getattr(x0, "ROW_FIRST", ()) else 0
            out[f.name] = np.stack(vals, axis)
        elif any(v != vals[0] for v in vals):
            raise ValueError(f"cannot batch these streams: {name} differs "
                             f"({vals[0]!r} in stream 0)")
    return dataclasses.replace(x0, **out)


def _zero_filled(slots: list) -> list:
    """One optional slot (a LutPass or PlaneGrad, or None) of each stream,
    with zero operands where some streams have it and others not."""
    have = next((x for x in slots if x is not None), None)
    if have is None:
        return slots
    zero = map_arrays(have, np.zeros_like)
    return [zero if x is None else x for x in slots]


def plnt_args(hdr, body: bytes, valid: np.ndarray | None = None):
    """Host planning of the PLNT plane decode (the copy of
    `jax_engine.plnt_device_args`): parse one PLNT chunk, `hdr` its
    `PlaneTile` header and `body` the bytes after it, into dense per-tile
    arrays. Returns (luts [T, 16] i32, codes [T, 64] i32 pre-clamped to each
    tile's LUT length, vmask [T, 64] bool, nty, ntx), or None when the bbox
    is empty. `valid` is the image's [H, W] bool mipmap mask (all pixels
    when None). PLNT never had an upstream decoder (deprecated at
    YAIK_API.cpp:567); this is the host half of the standalone plane
    reconstruction."""
    h, w = hdr.h, hdr.w
    nty, ntx = h // 8, w // 8
    if nty == 0 or ntx == 0:
        return None
    usize = zstd.frame_content_size(body[:hdr.stream_size_tile_map])
    if usize is None or usize > nty * ntx * 2:
        raise ValueError("PLNT tile map size missing or out of bounds")
    types = np.frombuffer(
        zstd.decompress(body[:hdr.stream_size_tile_map], usize), "<u2")
    codes_packed = zstd.decompress(
        body[hdr.stream_size_tile_map:
             hdr.stream_size_tile_map + hdr.stream_size_tile_stream],
        hdr.expected_size_tile_stream)
    nib = np.frombuffer(codes_packed, np.uint8)
    flat = np.empty(nib.size * 2, np.uint8)
    flat[0::2] = nib & 0xF
    flat[1::2] = nib >> 4

    if valid is None:
        vm = np.ones((nty * ntx, 64), bool)
    else:
        v = valid[hdr.y:hdr.y + h, hdr.x:hdr.x + w]
        vm = v.reshape(nty, 8, ntx, 8).transpose(0, 2, 1, 3).reshape(-1, 64)
    counts = vm.sum(axis=1)
    live = counts > 0                      # tiles that consumed a type word
    if int(live.sum()) > len(types):
        raise ValueError("PLNT tile map shorter than claimed tiles")
    ends = np.cumsum(counts)
    if int(ends[-1]) > flat.size:
        raise ValueError("PLNT code stream shorter than claimed pixels")

    t_of = np.zeros(nty * ntx, np.int64)
    t_of[live] = types[:int(live.sum())]
    luts = np.zeros((nty * ntx, 16), np.int32)
    lens = np.zeros(nty * ntx, np.int32)
    for t in np.unique(t_of[live]):
        bn = min_range_decode(int(t) & 0x7F)
        dist = diff_range_decode((int(t) >> 7) & 0x3F, bn)
        lut = np.asarray(curves_from(bn, dist)[int(t) >> 13], np.int32)
        rows = live & (t_of == t)
        luts[rows, :len(lut)] = lut
        lens[rows] = len(lut)

    codes = np.zeros((nty * ntx, 64), np.int32)
    codes[vm] = flat[:int(ends[-1])]
    codes = np.minimum(codes, np.maximum(lens - 1, 0)[:, None])
    return (luts, codes, vm, nty, ntx)
