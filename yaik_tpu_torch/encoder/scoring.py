"""Device encode scoring, in PyTorch: the counterpart of
`yaik_tpu.encoder.jax_scoring`.

- `gradient_packed` / `gradient_all`: the 6-variant bilinear accept test of
  every tile position (`gradient_all_device`), the 7 passes in order with
  claims evolving between them, over a batch of images [B, 3, H, W] (the
  JAX package vmaps it) or one image [3, H, W]: one launch of
  `kernels.grad_score` whatever B is, its accepts packed [B, G] u8;
- `tile3d_operands_b` / `tile3d_pass_b`: one 3D LUT size pass over a batch
  (`tile3d_pass_resident_b`): the images flattened into the tile axis
  (B * T rows), tile extraction, the claims mask, the per-tile bbox, with
  `cap_score` C only the first C tiles per image that hold an alive pixel
  (B * C rows) taken on to the two normalization chains,
  `kernels.score48_mode` (the pattern scores and their first-min argmin in
  one kernel) and `kernels.values48`, one launch each for the batch, the
  results scattered back to their tiles and the claims update;
- `tile3d_operands` / `tile3d_pass`: the same pass of one image, dense.

Everything is int32 and wraps where the JAX package's int32 arithmetic
wraps (dead pixels below a tile's alive minimum overflow `k63 * magic`);
the one float step, c = trunc((r / 2^20) * 63), divides by a power of two
and is exact on every device. Claims [B, 3, H, W] (or [3, H, W]) bool are
updated in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from yaik_tpu_torch.format import swizzle
from yaik_tpu_torch.encoder.tables import BankTables
from yaik_tpu_torch.ops import kernels
from yaik_tpu_torch.utils import profiler


def _claim(claims: torch.Tensor, accept: torch.Tensor, th: int, tw: int):
    """OR the [B, nty, ntx] accept grids' pixels into claims [B, 3, H, W],
    in place."""
    B, nty, ntx = accept.shape
    up = accept[:, :, None, :, None].expand(B, nty, th, ntx, tw)
    claims[:, :, :nty * th, :ntx * tw] |= up.reshape(
        B, 1, nty * th, ntx * tw)


def gradient_packed(planes: torch.Tensor, claims: torch.Tensor,
                    reject_factor: int, plain: bool = False) -> torch.Tensor:
    """The 7 gradient passes over planes [(B,) 3, H, W] i32 (made
    contiguous) with claims [(B,) 3, H, W] bool evolving in place: their
    accept grids packed as [(B,) G] u8 in `swizzle.GRADIENT_PASS_ORDER`.
    `kernels.grad_score` (one launch on the card, its plain version on the
    CPU), or with `plain` its plain version on any device."""
    fn = kernels.grad_score_plain if plain else kernels.grad_score
    return fn(planes.contiguous(), claims, reject_factor)


def split_accepts(packed, h: int, w: int) -> list:
    """[(B,) G] u8 packed accepts, a tensor or a numpy array -> the 7
    passes' grids [(B,) nty, ntx] bool of the same kind, views of
    `packed`."""
    flags = packed.view(torch.bool if isinstance(packed, torch.Tensor)
                        else bool)
    lead = packed.shape[:-1]
    out, off = [], 0
    for (sx, sy) in swizzle.GRADIENT_PASS_ORDER:
        nty, ntx = h >> sy, w >> sx
        out.append(flags[..., off:off + nty * ntx].reshape(*lead, nty, ntx))
        off += nty * ntx
    return out


def gradient_all(planes: torch.Tensor, claims: torch.Tensor,
                 reject_factor: int, plain: bool = False
                 ) -> list[torch.Tensor]:
    """The 7 gradient passes in `swizzle.GRADIENT_PASS_ORDER` (see
    gradient_packed); returns their accept grids (claims evolve in
    place)."""
    h, w = planes.shape[-2:]
    return split_accepts(gradient_packed(planes, claims, reject_factor,
                                         plain), h, w)


class Tile3DOperands(NamedTuple):
    """One 3D pass's per-tile operands (T tiles of P pixels)."""
    tiles: torch.Tensor     # [T, P, 3] i32 pixels, tile-major
    mask: torch.Tensor      # [T, P] bool: pixel claimed in all 3 planes
    c: torch.Tensor         # [T, P, 3] i32 scoring coordinates
    a_c: torch.Tensor       # [T, P, 3] i32 trunc(63 (t - mn) / d)
    b_c: torch.Tensor       # [T, P, 3] i32 trunc(63 - 63 (t - mn) / d)
    mn: torch.Tensor        # [T, 3] i32 over alive pixels (999 if none)
    mx: torch.Tensor        # [T, 3] i32 over alive pixels (-999 if none)
    pre: torch.Tensor       # [T] bool: an alive pixel, <= 1 flat channel


class Tile3DBatchOperands(NamedTuple):
    """One 3D pass's operands over a batch: `ops` holds the scored rows
    (every tile of the batch, B * T rows, or with a scoring cap C the
    first C tiles per image with an alive pixel, B * C rows); mask, mn and
    mx are every tile's, [B * T, ...]."""
    ops: Tile3DOperands
    mask: torch.Tensor
    mn: torch.Tensor
    mx: torch.Tensor
    src: torch.Tensor | None     # [B * C] i64: the tile row of each scored
    valid: torch.Tensor | None   # [B * C] bool: the row holds such a tile
    alive_cnt: torch.Tensor      # [B] i32: tiles with an alive pixel (0
    #                              when dense, as in the JAX package)


class Tile3DPass(NamedTuple):
    """One 3D pass's results over a batch of B images of T tiles."""
    accept: torch.Tensor      # [B, T] bool
    tile_type: torch.Tensor   # [B, T] i32
    idx: torch.Tensor         # [B, T, P] i32
    mask: torch.Tensor        # [B, T, P] bool
    mn: torch.Tensor          # [B, T, 3] i32
    mx: torch.Tensor          # [B, T, 3] i32
    alive_cnt: torch.Tensor   # [B] i32


def _normalize(tiles: torch.Tensor, mn: torch.Tensor, d: torch.Tensor):
    """(c, a_c, b_c) of tiles [N, P, 3] with bbox minimum mn and extent d
    [N, 3]: the scoring coordinates and both computeValues chains."""
    k = tiles - mn[:, None]
    dpos = (d > 0)[:, None]
    d1 = d.clamp(min=1)[:, None]
    nvec = torch.where(dpos, (1 << 20) // d1, 0)
    c = (((k * nvec).float() / float(1 << 20)) * 63.0).to(torch.int32)
    # exact floor division by magic multiply (jax_scoring: q = (n*M) >> 22
    # == n // d for n = 63k, k <= d <= 255); wraps for dead pixels as there
    k63 = k * 63
    q0 = (k63 * ((1 << 22) // d1 + 1)) >> 22
    q = torch.where(dpos, q0, k63)
    rem = torch.where(dpos, k63 - q0 * d1, 0)
    b_c = 63 - q - (rem != 0).to(torch.int32)
    return c, q, b_c


def _select_alive(live: torch.Tensor, cap: int):
    """The first `cap` tiles per image of live [B, T] (cumsum, then
    searchsorted, as jax_scoring): (src [B * cap] flat tile rows, clamped
    at each image's last tile; valid [B * cap]; alive_cnt [B] i32)."""
    B, T = live.shape
    dev = live.device
    csum = live.to(torch.int32).cumsum(1, dtype=torch.int32)
    alive_cnt = (csum[:, -1] if T else
                 torch.zeros(B, dtype=torch.int32, device=dev))
    targets = torch.arange(1, cap + 1, dtype=torch.int32,
                           device=dev).expand(B, cap).contiguous()
    pos = torch.searchsorted(csum, targets)
    src = (torch.arange(B, device=dev)[:, None] * T
           + pos.clamp(max=max(T - 1, 0))).reshape(-1)
    valid = (targets <= alive_cnt[:, None]).reshape(-1)
    return src, valid, alive_cnt


def tile3d_operands_b(planes: torch.Tensor, claims: torch.Tensor, sx: int,
                      sy: int, cap_score: int | None = None
                      ) -> Tile3DBatchOperands:
    """Tiles, mask and bbox of one pass over planes / claims [B, 3, H, W],
    and both normalization chains of the rows to score: every tile, or
    with `cap_score` the first cap_score tiles per image that hold an
    alive pixel (tiles past an image's count are rows masked dead)."""
    tw, th = 1 << sx, 1 << sy
    B, _, h, w = planes.shape
    ntx, nty = w // tw, h // th
    T, P = nty * ntx, th * tw
    tiles = planes[:, :, :nty * th, :ntx * tw].reshape(B, 3, nty, th, ntx, tw)
    tiles = tiles.permute(0, 2, 4, 3, 5, 1).reshape(B * T, P, 3)
    mask = claims.all(1)[:, :nty * th, :ntx * tw].reshape(B, nty, th, ntx, tw)
    mask = mask.permute(0, 1, 3, 2, 4).reshape(B * T, P)
    alive = ~mask
    mn = torch.where(alive[..., None], tiles, 999).amin(1)
    mx = torch.where(alive[..., None], tiles, -999).amax(1)
    d = mx - mn
    pre = alive.any(1) & ((d == 0).sum(1) <= 1)
    if cap_score is None:
        src = valid = None
        alive_cnt = torch.zeros(B, dtype=torch.int32, device=planes.device)
        s_tiles, s_alive, s_mn, s_mx, s_pre = tiles, alive, mn, mx, pre
    else:
        src, valid, alive_cnt = _select_alive(alive.any(1).reshape(B, T),
                                              cap_score)
        s_tiles, s_mn, s_mx = tiles[src], mn[src], mx[src]
        s_alive = alive[src] & valid[:, None]
        s_pre = pre[src] & valid
    # contiguous before normalizing: with one tile column the reshape above
    # is a strided view, and c, a_c, b_c would keep its strides
    s_tiles = s_tiles.contiguous()
    c, a_c, b_c = _normalize(s_tiles, s_mn, s_mx - s_mn)
    ops = Tile3DOperands(s_tiles, ~s_alive, c, a_c, b_c, s_mn, s_mx, s_pre)
    return Tile3DBatchOperands(ops, mask, mn, mx, src, valid, alive_cnt)


def tile3d_operands(planes: torch.Tensor, claims: torch.Tensor, sx: int,
                    sy: int) -> Tile3DOperands:
    """Tiles, mask, bbox and both normalization chains of one image's
    pass (planes / claims [3, H, W]), every tile."""
    return tile3d_operands_b(planes[None], claims[None], sx, sy).ops


def _score(ops: Tile3DOperands, tables: BankTables, plain: bool):
    """(accept, tile_type, idx) of the operands' rows: score48_mode, then
    values48, each one launch (their plain versions with `plain`). A pass
    with no row (no whole tile: the 16x8 and 8x16 passes of an 8x8 image)
    scores nothing, calls neither kernel and counts one
    `score_passes_empty`."""
    alive = ~ops.mask
    if not alive.shape[0]:
        profiler.count("score_passes_empty")
        dev = alive.device
        return (torch.zeros(0, dtype=torch.bool, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(alive.shape, dtype=torch.int32, device=dev))
    score = kernels.score48_mode_plain if plain else kernels.score48_mode
    values = kernels.values48_plain if plain else kernels.values48
    mode48 = score(ops.c, alive, tables.qpts)
    acc, tile_type, idx = values(ops.tiles, alive, ops.a_c, ops.b_c, mode48,
                                 ops.mn, ops.mx - ops.mn, tables.pts,
                                 tables.factors)
    return acc & ops.pre, tile_type, idx


def _scatter(rows: torch.Tensor, src: torch.Tensor, valid: torch.Tensor,
             n: int) -> torch.Tensor:
    """[n, ...] zeros with the valid rows at their tiles; the others go to
    a spare row n that is dropped (no host sync, as `mode="drop"`)."""
    out = rows.new_zeros((n + 1,) + rows.shape[1:])
    out[torch.where(valid, src, n)] = rows
    return out[:n]


def tile3d_pass_b(planes: torch.Tensor, claims: torch.Tensor,
                  tables: BankTables, sx: int, sy: int,
                  cap_score: int | None = None, plain: bool = False
                  ) -> Tile3DPass:
    """One 3D pass over planes / claims [B, 3, H, W] (see
    tile3d_operands_b); claims take the accepted tiles. With a cap, a
    tile left unscored has accept, type and idx 0, and alive_cnt above
    the cap tells the caller so. `plain` scores with the kernels' plain
    versions on any device."""
    B, _, h, w = planes.shape
    tw, th = 1 << sx, 1 << sy
    nty, ntx = h // th, w // tw
    T, P = nty * ntx, th * tw
    bo = tile3d_operands_b(planes, claims, sx, sy, cap_score)
    accept, tile_type, idx = _score(bo.ops, tables, plain)
    if bo.src is not None:
        accept, tile_type, idx = (_scatter(x, bo.src, bo.valid, B * T)
                                  for x in (accept, tile_type, idx))
    _claim(claims, accept.reshape(B, nty, ntx), th, tw)
    return Tile3DPass(accept.reshape(B, T), tile_type.reshape(B, T),
                      idx.reshape(B, T, P), bo.mask.reshape(B, T, P),
                      bo.mn.reshape(B, T, 3), bo.mx.reshape(B, T, 3),
                      bo.alive_cnt)


def tile3d_pass(planes: torch.Tensor, claims: torch.Tensor,
                tables: BankTables, sx: int, sy: int, plain: bool = False):
    """One dense 3D LUT pass of one image (planes / claims [3, H, W]).
    Returns (accept [T] bool, tile_type [T] i32, idx [T, P] i32,
    Tile3DOperands); claims take the accepted tiles. `plain` scores with
    the kernels' plain versions on any device."""
    ops = tile3d_operands(planes, claims, sx, sy)
    accept, tile_type, idx = _score(ops, tables, plain)
    _, h, w = planes.shape
    _claim(claims[None], accept.reshape(1, h >> sy, w >> sx), 1 << sy,
           1 << sx)
    return accept, tile_type, idx, ops
