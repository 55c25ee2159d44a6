"""Device scoring pipelines: the counterpart of
`yaik_tpu.encoder.device_pipeline`.

Every pass runs over a batch [B, 3, H, W] of planes, one launch of each
scoring kernel for the whole batch, with planes and claims on the device
across all 13 passes:
- `upload` sends [H, W, 3|4] u8 images as their RGB bytes and makes the
  i32 planes on the device;
- `_resident_packed` packs a pass's results into one u8 row per tile,
  [B, T, P+9] = idx | mask << 6 (P bytes), accept, type (2 bytes, little
  endian), bbox (mn | mx, 6 bytes); `_tile3d_all` concatenates all six
  passes' rows per image;
- `score_dense` is the dense scoring of image rows (one image, a band of
  one, or one band per device): the upload, the gradient passes and
  `_tile3d_all`, the joined blob brought back in one copy and unpacked
  into the 7 accept grids and the six passes' dense dicts
  (`api.score_image`, `batch.encode_image_banded`,
  `batch.encode_image_banded_mesh`);
- `_compact_pass` / `_tile3d_all_compact` download only what emission
  reads: per pass the accept bits over the scan-order tiles, the accepted
  count and the alive-tile count (u32 little endian each), and the first
  `dcap` accepted tiles' rows in scan order (rows past the count repeat
  the gather of the last scan tile); with scoring caps, only the first
  `scap` alive tiles of each image are scored (`batch.encode_batch`).

`tile3d_all` runs the six passes of one image through the one-image
`scoring.tile3d_pass`, its results left on the device.

The host side is numpy: `pass_caps`, `caps_fit`, `unpack_compact` and
`_unpack_pass`, copies of their JAX originals, and `unpack_dense`.
"""
from __future__ import annotations

import numpy as np
import torch

from yaik_tpu_torch.decoder.engine import to_card, to_host
from yaik_tpu_torch.format import swizzle
from yaik_tpu_torch.encoder import scoring
from yaik_tpu_torch.encoder.emit import _scan_perm
from yaik_tpu_torch.encoder.tables import BankTables
from yaik_tpu_torch.ops import kernels
from yaik_tpu_torch.utils import profiler


def tile3d_all(planes: torch.Tensor, claims: torch.Tensor,
               tables: BankTables, plain: bool = False) -> list[dict]:
    """The six 3D passes in `swizzle.TILE3D_PASS_ORDER`, on the device.
    Per pass a dict of device tensors: shift (sx, sy), accept [T] bool,
    type [T] i32, bbox [T, 6] u8 (mn | mx), idx [T, P] u8, mask [T, P]
    bool. Claims evolve in place."""
    results = []
    for (sx, sy) in swizzle.TILE3D_PASS_ORDER:
        accept, tile_type, idx, ops = scoring.tile3d_pass(
            planes, claims, tables, sx, sy, plain=plain)
        results.append({
            "shift": (sx, sy), "accept": accept, "type": tile_type,
            "bbox": torch.cat([ops.mn, ops.mx], 1).to(torch.uint8),
            "idx": idx.to(torch.uint8), "mask": ops.mask})
    return results


def upload(imgs: list, dev: torch.device) -> torch.Tensor:
    """[B, 3, H, W] i32 planes on `dev` of [H, W, 3|4] u8 images: their RGB
    bytes sent as u8 (a quarter of the planes' bytes), made planar and
    widened there."""
    with profiler.stage("encode:upload"):
        rgb = np.stack([im[:, :, :3] for im in imgs])
        return to_card(rgb, dev).permute(0, 3, 1, 2).to(
            torch.int32, memory_format=torch.contiguous_format)


def score_dense(bands: list, reject_factor: int, plain: bool = False
                ) -> list:
    """Dense scoring of image rows: for each (rows [h, w, 3|4] u8, tables)
    of `bands`, the rows uploaded once (`upload`) to the tables' device,
    the 7 gradient passes (`scoring.gradient_packed`) and the six 3D
    passes (`_tile3d_all`) queued there, every band queued before the
    first is brought back, then each band's blob downloaded in one copy
    and unpacked (`unpack_dense`). `plain` scores with the kernels' plain
    versions. Returns per band (the 7 accept grids [h >> sy, w >> sx]
    bool, the six passes' dense dicts)."""
    blobs = []
    for rows, tables in bands:
        planes = upload([rows], tables.qpts.device)
        claims = torch.zeros(planes.shape, dtype=torch.bool,
                             device=planes.device)
        with profiler.stage("encode:gradient-scoring"):
            packed_g = scoring.gradient_packed(planes, claims, reject_factor,
                                               plain)
        with profiler.stage("encode:3d-scoring"):
            packed_t3 = _tile3d_all(planes, claims, tables, plain)
        blobs.append(torch.cat([packed_g, packed_t3], dim=1)[0])
    out = []
    for (rows, _), blob in zip(bands, blobs):
        with profiler.stage("encode:download"):
            out.append(unpack_dense(to_host(blob), *rows.shape[1::-1]))
    return out


# -- a batch on the device ----------------------------------------------------

def _resident_packed(planes: torch.Tensor, claims: torch.Tensor,
                     tables: BankTables, sx: int, sy: int,
                     cap_score: int | None = None, plain: bool = False):
    """One 3D pass over a batch [B, 3, H, W], packed: ([B, T, P+9] u8,
    alive_cnt [B] i32). Claims evolve in place."""
    r = scoring.tile3d_pass_b(planes, claims, tables, sx, sy, cap_score,
                              plain)
    u8 = torch.uint8
    packed = torch.cat([
        (r.idx | (r.mask.to(torch.int32) << 6)).to(u8),
        r.accept.to(u8)[:, :, None],
        (r.tile_type & 0xFF).to(u8)[:, :, None],
        ((r.tile_type >> 8) & 0xFF).to(u8)[:, :, None],
        r.mn.to(u8), r.mx.to(u8)], dim=2)
    return packed, r.alive_cnt


def _tile3d_all(planes: torch.Tensor, claims: torch.Tensor,
                tables: BankTables, plain: bool = False) -> torch.Tensor:
    """All six 3D passes over a batch, dense: [B, sum of T * (P+9)] u8,
    pass-major per image. Claims evolve in place."""
    B = planes.shape[0]
    return torch.cat([
        _resident_packed(planes, claims, tables, sx, sy,
                         plain=plain)[0].reshape(B, -1)
        for (sx, sy) in swizzle.TILE3D_PASS_ORDER], dim=1)


def _u32_bytes(v: torch.Tensor) -> list[torch.Tensor]:
    return [(v >> s) & 0xFF for s in (0, 8, 16, 24)]


def _compact_pass(packed: torch.Tensor, perm: torch.Tensor, cap: int,
                  alive_cnt: torch.Tensor | None = None) -> torch.Tensor:
    """packed [B, T, P+9] u8, perm [Ts] the scan-order tile ids, alive_cnt
    [B] (0 when scoring ran dense) -> [B, ceil(Ts/8) + 8 + cap*(P+9)] u8:
    the accept bits in scan order (bit i of byte i // 8 is tile i % 8),
    count and alive_cnt as u32 LE, then the first `cap` accepted rows."""
    B, T, W = packed.shape
    Ts = perm.shape[0]
    dev = packed.device
    acc = packed[:, :, W - 9].index_select(1, perm) > 0          # [B, Ts]
    csum = acc.to(torch.int32).cumsum(1, dtype=torch.int32)
    cnt = csum[:, -1] if Ts else torch.zeros(B, dtype=torch.int32,
                                             device=dev)
    targets = torch.arange(1, cap + 1, dtype=torch.int32,
                           device=dev).expand(B, cap).contiguous()
    pos = torch.searchsorted(csum, targets).clamp(max=max(Ts - 1, 0))
    src = perm[pos]                                               # [B, cap]
    rows = torch.gather(packed, 1, src[:, :, None].expand(B, cap, W))
    ts8 = -(-Ts // 8) * 8
    accp = torch.nn.functional.pad(acc, (0, ts8 - Ts)).reshape(B, -1, 8)
    bit = torch.arange(8, dtype=torch.int32, device=dev)
    cbits = (accp.to(torch.int32) << bit).sum(-1, dtype=torch.int32)
    if alive_cnt is None:
        alive_cnt = torch.zeros(B, dtype=torch.int32, device=dev)
    cnt8 = torch.stack(_u32_bytes(cnt) + _u32_bytes(alive_cnt), dim=1)
    return torch.cat([cbits.to(torch.uint8), cnt8.to(torch.uint8),
                      rows.reshape(B, -1)], dim=1)


def _tile3d_all_compact(planes: torch.Tensor, claims: torch.Tensor,
                        tables: BankTables, perms: list, caps: tuple
                        ) -> torch.Tensor:
    """All six 3D passes over a batch with compacted scoring and download:
    per pass (scap, dcap) of `caps` and the scan-order tile ids of `perms`
    (device tensors), `_compact_pass` of the pass scored with cap scap.
    Returns [B, n] u8, pass-major per image. Claims evolve in place."""
    outs = []
    for (sx, sy), perm, (scap, dcap) in zip(swizzle.TILE3D_PASS_ORDER,
                                            perms, caps):
        packed, alive_cnt = _resident_packed(planes, claims, tables, sx, sy,
                                             cap_score=scap)
        outs.append(_compact_pass(packed, perm, dcap, alive_cnt))
    return torch.cat(outs, dim=1)


def scan_perms(w: int, h: int, device) -> list[torch.Tensor]:
    """Each 3D pass's scan-order tile ids (`_scan_perm`) on `device`."""
    return [to_card(_scan_perm(sx, sy, w, h)[1].astype(np.int64), device)
            for (sx, sy) in swizzle.TILE3D_PASS_ORDER]


# -- the host side of the compaction (numpy) -----------------------------------

def _unpack_pass(packed: np.ndarray, P: int):
    """[T, P+9] u8 rows -> (idx [T, P] u8, mask [T, P] bool, accept [T]
    bool, type [T] i32, bbox [T, 6] u8) of one pass; idx and mask are
    views of arrays made in one pass over the whole rows, accept and bbox
    views of `packed`."""
    idx = (packed & 63)[:, :P]
    mask = (packed >= 64)[:, :P]
    accept = packed[:, P].view(bool)
    typ = (packed[:, P + 1].astype(np.int32)
           | (packed[:, P + 2].astype(np.int32) << 8))
    bbox = packed[:, P + 3:P + 9]
    return idx, mask, accept, typ, bbox


def unpack_dense(flat: np.ndarray, w: int, h: int) -> tuple:
    """`score_dense`'s blob of one w x h image (its packed gradient
    accepts, then `_tile3d_all`'s rows) -> (the 7 accept grids, per 3D
    pass a dict of shift, idx, mask, accept, type and bbox)."""
    G = kernels.grad_score_len(h, w)
    t3, off = [], G
    for (sx, sy) in swizzle.TILE3D_PASS_ORDER:
        P = (1 << sx) * (1 << sy)
        n = (h >> sy) * (w >> sx) * (P + 9)
        idx, mask, accept, typ, bbox = _unpack_pass(
            flat[off:off + n].reshape(-1, P + 9), P)
        t3.append({"shift": (sx, sy), "idx": idx, "mask": mask,
                   "accept": accept, "type": typ, "bbox": bbox})
        off += n
    return scoring.split_accepts(flat[:G], h, w), t3


def pass_caps(w: int, h: int, frac: int = 8, dfrac: int = 16,
              scale: int = 1) -> tuple:
    """Per-pass (scoring, download) tile caps: T / frac and T / dfrac, at
    least 64, times `scale`, at most T. Scoring cap: how many tiles with
    an alive pixel are scored per image; download cap: how many accepted
    tiles' rows cross the link. The JAX package's YAIK_ENC_CAP_FRAC and
    YAIK_ENC_DCAP_FRAC are `frac` and `dfrac` here."""
    caps = []
    for (sx, sy) in swizzle.TILE3D_PASS_ORDER:
        T = (h >> sy) * (w >> sx)
        caps.append((min(T, max(64, T // frac) * scale),
                     min(T, max(64, T // dfrac) * scale)))
    return tuple(caps)


def caps_fit(per_pass: list, caps_used: tuple, w: int, h: int) -> tuple:
    """Caps that fit an unpacked blob with 1.5x headroom, rounded up to
    powers of two, never below `caps_used`, at most T; where the scoring
    cap overflowed, the accepted count is extrapolated by alive / scap.
    Returns `caps_used` itself when nothing overflowed."""
    def p2(x):
        return 1 << max(0, (int(x) - 1)).bit_length()

    fit, grew = [], False
    for res, (scap, dcap) in zip(per_pass, caps_used):
        sx, sy = res["shift"]
        T = (h >> sy) * (w >> sx)
        alive = res["alive"].astype(np.int64)
        count = res["count"].astype(np.int64)
        a = int(alive.max())
        c = int((count * np.maximum(alive, scap) // scap).max())
        if a <= scap and int(count.max()) <= dcap:
            fit.append((scap, dcap))
            continue
        grew = True
        fit.append((min(T, max(scap, p2(a * 3 // 2))),
                    min(T, max(dcap, p2(c * 3 // 2)))))
    return tuple(fit) if grew else caps_used


def unpack_compact(flat: np.ndarray, w: int, h: int, caps: tuple) -> list:
    """`_tile3d_all_compact`'s blob [B, n] u8 -> per pass a dict of shift,
    bits_scan [B, Ts] bool, count [B], alive [B] and rows [B, dcap, P+9]
    (rows past count are not accepted tiles). count > dcap or alive >
    scap means a cap overflowed."""
    out, off = [], 0
    for pi, (sx, sy) in enumerate(swizzle.TILE3D_PASS_ORDER):
        P = (1 << sx) * (1 << sy)
        Ts = _scan_perm(sx, sy, w, h)[1].shape[0]
        nb = -(-Ts // 8)
        cap = caps[pi][1]
        cbits = flat[:, off:off + nb]
        off += nb

        def u32(o):
            return (flat[:, o].astype(np.int64)
                    | (flat[:, o + 1].astype(np.int64) << 8)
                    | (flat[:, o + 2].astype(np.int64) << 16)
                    | (flat[:, o + 3].astype(np.int64) << 24))
        cnt, alive = u32(off), u32(off + 4)
        off += 8
        rows = flat[:, off:off + cap * (P + 9)].reshape(-1, cap, P + 9)
        off += cap * (P + 9)
        bits = np.unpackbits(cbits, axis=1, bitorder="little")[:, :Ts]
        out.append({"shift": (sx, sy), "bits_scan": bits.astype(bool),
                    "count": cnt, "alive": alive, "rows": rows})
    return out
