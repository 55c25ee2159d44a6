"""Device encode scoring, in PyTorch: the counterpart of
`yaik_tpu.encoder.jax_scoring` for the dense single-image path.

- `gradient_pass` / `gradient_all`: the 6-variant bilinear accept test of
  every tile position (`gradient_pass_device` / `gradient_all_device`), the
  7 passes in order with claims evolving between them;
- `tile3d_operands` / `tile3d_pass`: one dense 3D LUT size pass
  (`tile3d_pass_resident_b` with B = 1 and no scoring cap): tile
  extraction, the claims mask, the per-tile bbox, the two normalization
  chains, `kernels.score48_mode` (the pattern scores and their first-min
  argmin in one kernel), `kernels.values48` and the claims update.

Everything is int32 and wraps where the JAX package's int32 arithmetic
wraps (dead pixels below a tile's alive minimum overflow `k63 * magic`);
the one float step, c = trunc((r / 2^20) * 63), divides by a power of two
and is exact on every device. Claims [3, H, W] bool are updated in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from yaik_tpu_torch.encoder.gradient import ROUNDING
from yaik_tpu_torch.format import swizzle
from yaik_tpu_torch.encoder.tables import BankTables
from yaik_tpu_torch.ops import kernels


def round6(v: torch.Tensor) -> torch.Tensor:
    r = v >> 2
    return (r << 2) | (r >> 4)


def round6p(v: torch.Tensor) -> torch.Tensor:
    return round6(torch.clamp(v + 1, max=255))


def _claim(claims: torch.Tensor, accept: torch.Tensor, th: int, tw: int):
    """OR the [nty, ntx] accept grid's pixels into claims, in place."""
    nty, ntx = accept.shape
    up = accept[:, None, :, None].expand(nty, th, ntx, tw)
    claims[:, :nty * th, :ntx * tw] |= up.reshape(nty * th, ntx * tw)


def _weights(t: int, dev: torch.device) -> torch.Tensor:
    """gradient.WEIGHTS[t] = 1024 - i * 1024 / t, made on the device (a
    copy from the host would synchronize the stream)."""
    return 1024 - torch.arange(t, dtype=torch.int32, device=dev) * (1024 // t)


def gradient_pass(planes: torch.Tensor, claims: torch.Tensor, sx: int,
                  sy: int, reject_factor: int) -> torch.Tensor:
    """planes [3, H, W] i32, claims [3, H, W] bool -> accept [nty, ntx]
    bool of the (1<<sx) x (1<<sy) pass; claims take the accepted tiles."""
    tw, th = 1 << sx, 1 << sy
    _, h, w = planes.shape
    ntx, nty = w // tw, h // th
    dev = planes.device
    xs = torch.arange(0, (ntx + 1) * tw, tw, device=dev).clamp(max=w - 1)
    ys = torch.arange(0, (nty + 1) * th, th, device=dev).clamp(max=h - 1)
    corners = planes[:, ys[:, None], xs[None, :]]        # [3, nty+1, ntx+1]
    c00, c01 = corners[:, :nty, :ntx], corners[:, :nty, 1:]
    c10, c11 = corners[:, 1:, :ntx], corners[:, 1:, 1:]
    pix = planes[:, :nty * th, :ntx * tw].reshape(3, nty, th, ntx, tw)
    pix = pix.permute(0, 1, 3, 2, 4)                  # [3, nty, ntx, th, tw]
    lf = _weights(tw, dev).reshape(1, 1, 1, 1, tw)
    tf = _weights(th, dev).reshape(1, 1, 1, th, 1)

    def blends(a, b, c, d):
        # int32 suffices: blends peak at 255*1024*1024 + 2^19 < 2^31
        top = a[..., None, None] * lf + b[..., None, None] * (1024 - lf)
        bot = c[..., None, None] * lf + d[..., None, None] * (1024 - lf)
        num = top * tf + bot * (1024 - tf)
        return (num + ROUNDING) >> 20, num >> 20

    ok = torch.zeros((nty, ntx), dtype=torch.bool, device=dev)
    for rnd in (lambda v: v, round6, round6p):
        for bl in blends(rnd(c00), rnd(c01), rnd(c10), rnd(c11)):
            ok |= ((pix - bl).abs() <= reject_factor).all(-1).all(-1).all(0)
    origins = claims[:, ::th, ::tw][:, :nty, :ntx]
    accept = ok & ~origins.any(0)
    _claim(claims, accept, th, tw)
    return accept


def gradient_all(planes: torch.Tensor, claims: torch.Tensor,
                 reject_factor: int) -> list[torch.Tensor]:
    """The 7 gradient passes in `swizzle.GRADIENT_PASS_ORDER`; returns
    their accept grids (claims evolve in place)."""
    return [gradient_pass(planes, claims, sx, sy, reject_factor)
            for (sx, sy) in swizzle.GRADIENT_PASS_ORDER]


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


def tile3d_operands(planes: torch.Tensor, claims: torch.Tensor, sx: int,
                    sy: int) -> Tile3DOperands:
    """Tiles, mask, bbox and both normalization chains of one pass."""
    tw, th = 1 << sx, 1 << sy
    _, h, w = planes.shape
    ntx, nty = w // tw, h // th
    T, P = nty * ntx, th * tw
    tiles = planes[:, :nty * th, :ntx * tw].reshape(3, nty, th, ntx, tw)
    tiles = tiles.permute(1, 3, 2, 4, 0).reshape(T, P, 3)
    mask = claims.all(0)[:nty * th, :ntx * tw].reshape(nty, th, ntx, tw)
    mask = mask.permute(0, 2, 1, 3).reshape(T, P)
    alive = ~mask
    mn = torch.where(alive[..., None], tiles, 999).amin(1)
    mx = torch.where(alive[..., None], tiles, -999).amax(1)
    d = mx - mn
    pre = alive.any(1) & ((d == 0).sum(1) <= 1)
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
    return Tile3DOperands(tiles.contiguous(), mask, c, q, b_c, mn, mx, pre)


def tile3d_pass(planes: torch.Tensor, claims: torch.Tensor,
                tables: BankTables, sx: int, sy: int, plain: bool = False):
    """One dense 3D LUT pass. Returns (accept [T] bool, tile_type [T] i32,
    idx [T, P] i32, Tile3DOperands); claims take the accepted tiles.
    `plain` scores with the kernels' plain versions on any device."""
    ops = tile3d_operands(planes, claims, sx, sy)
    alive = ~ops.mask
    score = kernels.score48_mode_plain if plain else kernels.score48_mode
    values = kernels.values48_plain if plain else kernels.values48
    mode48 = score(ops.c, alive, tables.qpts)
    acc, tile_type, idx = values(ops.tiles, alive, ops.a_c, ops.b_c, mode48,
                                 ops.mn, ops.mx - ops.mn, tables.pts,
                                 tables.factors)
    accept = acc & ops.pre
    _, h, w = planes.shape
    _claim(claims, accept.reshape(h >> sy, w >> sx), 1 << sy, 1 << sx)
    return accept, tile_type, idx, ops
