"""The port's hand-written kernels, each beside its plain PyTorch version.

Counterpart of `yaik_tpu/ops/pallas_kernels.py` for the device decode
(every branch of `jax_engine.decode_core`) and the device-scored encode:

- `grad_plane` (csrc/grad_plane.cu) replaces the Pallas `grad_plane`, and
  serves the plane-variant gradient passes too;
- `grad_plane_final` (csrc/grad_plane.cu, the final-composition epilogue)
  replaces the Pallas `grad_plane_final`;
- `t3_merged` (csrc/t3_merged.cu) replaces `lut3d_vals_dict2p`
  (chan=False) and `lut3d_vals` on merged T3 layers;
- `t3_merged_d1` (csrc/t3_merged.cu, the 1D-residual epilogue, image
  order) replaces `lut3d_vals_dict2p_d1`;
- `t2_merged` (csrc/t3_merged.cu, the per-channel compose) replaces
  `lut3d_vals_dict2p` (chan=True) and `lut3d_vals` on merged 2DTL layers;
- `lut_pass` (csrc/lut_pass.cu) replaces `lut3d_vals` and
  `lut3d_vals_dict` on one T3 or 2DTL size pass, writing image order;
- `score48` (csrc/score48.cu) replaces the Pallas `score48`;
- `score48_mode` (csrc/score48.cu, the pattern-argmin epilogue) replaces
  the Pallas `score48` together with the `argmin` that follows it;
- `values48` (csrc/values48.cu) replaces the Pallas `values48` and the XLA
  values stage it twins;
- `grad_score` (csrc/grad_score.cu) replaces no Pallas kernel: it computes
  the encoder's gradient stage, the 7 gradient passes with claims evolving
  between them, in one launch, XLA on the TPU
  (`yaik_tpu/encoder/jax_scoring.py` `gradient_all_device`): a warp per
  16x16 block and image, a lane a column of 8 rows, each blend's
  numerator stepped down the column and each blend test a range check on
  the least and greatest of the lane's values;
- `covers` and `covers2d` (csrc/covers.cu) replace no Pallas kernel: they
  compute the LUT-bank miner's coverage matrices, XLA on the TPU
  (`yaik_tpu/encoder/mining.py` `_covers_device`, `_covers2d_device`).

A wrapper runs the plain version for tensors on the CPU, launches its CUDA
kernel on `torch.cuda.current_stream()` for tensors on a CUDA device, and
raises for anything else: there is no fallback from a CUDA tensor. Each
wrapper counts its kernel launches in its `launches` attribute, and those
on each device in its `per_device` dict.

The decode kernels take a batch of B same-size images in one launch (the
counterpart of the JAX package's vmap over `decode_core`): `grad_plane`,
`grad_plane_final` and `lut_pass` take a leading batch axis on every
per-image operand; `t3_merged`, `t2_merged` and `t3_merged_d1` take their
layers as [2, B, G4, ...] and the 1D operands as [rows, B, G4], so the
launch runs over the B * G4 blocks of the batch. Without the batch axis a
call is one image, as before.

Kernel and plain version agree exactly: the arithmetic is integer, or
float32 in one fixed op order (values48's distances).
"""
from __future__ import annotations

import ctypes
import math

import torch

from yaik_tpu_torch.decoder.pack import GRAD_SHIFTS
from yaik_tpu_torch.encoder.gradient import ROUNDING
from yaik_tpu_torch.format import swizzle
from yaik_tpu_torch.ops import build

_SHIFTS = (ctypes.c_int * 14)(*[s[0] for s in GRAD_SHIFTS],
                              *[s[1] for s in GRAD_SHIFTS])


def _expect(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
            device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _route(device: torch.device) -> bool:
    """True for the CUDA kernel, False for the plain version (CPU)."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {device}")


def _count(fn, dev: torch.device) -> None:
    """One launch of `fn`'s kernel on `dev`: one more in `fn.launches` and
    in `fn.per_device[dev]`."""
    fn.launches += 1
    fn.per_device[dev] = fn.per_device.get(dev, 0) + 1


# a batch is one grid axis of a launch
MAX_BATCH = 65535


def _lead(t: torch.Tensor, name: str, ndim: int) -> tuple:
    """() when `t` has the `ndim` dims of one image, (B,) when it has a
    leading batch axis as well; raises otherwise."""
    if t.ndim == ndim:
        return ()
    if t.ndim == ndim + 1 and t.shape[0] <= MAX_BATCH:
        return (t.shape[0],)
    raise ValueError(f"{name} has shape {tuple(t.shape)}: expected {ndim} "
                     f"dims, or {ndim + 1} with a batch of <= {MAX_BATCH}")


def grad_plane_plain(corners: torch.Tensor, code4: torch.Tensor
                     ) -> torch.Tensor:
    """corners [7, qh, qw] i32 packed corner grids, code4 [H/4, W/4] u8
    winner codes -> [H, W] i32: the winning pass's exact integer bilinear,
    c0 | c1<<8 | c2<<16 | 1<<24, and 0 where the code is not in 1..7. With
    a leading batch axis on both operands, [B, H, W]."""
    qh, qw = corners.shape[-2:]
    hq, wq = code4.shape[-2:]
    H, W, lead = hq * 4, wq * 4, code4.shape[:-2]
    dev = corners.device
    cs = corners.reshape(-1, 7, qh * qw)                       # [N, 7, qh*qw]
    k = code4.reshape(-1, hq, wq).to(torch.int64).repeat_interleave(
        4, 1).repeat_interleave(4, 2)                          # [N, H, W]
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    out = torch.zeros(k.shape, dtype=torch.int32, device=dev)
    for p, (sx, sy) in enumerate(GRAD_SHIFTS):
        tw, th = 1 << sx, 1 << sy
        qsx, qsy = tw // 4, th // 4
        ry, rx = ys & (th - 1), xs & (tw - 1)
        r0 = ((ys >> sy) * qsy).clamp(max=qh - 1) * qw
        r1 = ((ys >> sy) * qsy + qsy).clamp(max=qh - 1) * qw
        q0 = ((xs >> sx) * qsx).clamp(max=qw - 1)
        q1 = ((xs >> sx) * qsx + qsx).clamp(max=qw - 1)
        c = cs[:, p]
        c00, c01, c10, c11 = (c[:, r + q] for r, q in ((r0, q0), (r0, q1),
                                                        (r1, q0), (r1, q1)))
        v = torch.full(k.shape, 1 << 24, dtype=torch.int32, device=dev)
        for ch in range(3):
            a00, a01, a10, a11 = ((x >> (8 * ch)) & 0xFF
                                  for x in (c00, c01, c10, c11))
            val = ((th - ry) * ((tw - rx) * a00 + rx * a01)
                   + ry * ((tw - rx) * a10 + rx * a11)) >> (sx + sy)
            v |= (val << (8 * ch)).to(torch.int32)
        out = torch.where(k == p + 1, v, out)
    return out.reshape(*lead, H, W)


def _grad_geometry(corners: torch.Tensor, code4: torch.Tensor) -> tuple:
    """(batch lead, H/4, W/4) of grad_plane's operands, checked."""
    lead = _lead(code4, "code4", 2)
    hq, wq = code4.shape[-2:]
    _expect(corners, "corners", torch.int32, lead + (7, hq + 1, wq + 1),
            corners.device)
    _expect(code4, "code4", torch.uint8, lead + (hq, wq), corners.device)
    return lead, hq, wq


def grad_plane(corners: torch.Tensor, code4: torch.Tensor) -> torch.Tensor:
    """Merged gradient plane (see grad_plane_plain). corners [7, H/4+1,
    W/4+1] i32, code4 [H/4, W/4] u8, both contiguous on one device; or a
    batch, corners [B, 7, ...] and code4 [B, ...] -> [B, H, W], one
    launch."""
    dev = corners.device
    lead, hq, wq = _grad_geometry(corners, code4)
    if not _route(dev):
        return grad_plane_plain(corners, code4)
    H, W = hq * 4, wq * 4
    out = torch.empty(lead + (H, W), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = build.library().yaik_grad_plane(
            corners.data_ptr(), code4.data_ptr(), ctypes.addressof(_SHIFTS),
            out.data_ptr(), math.prod(lead), hq + 1, wq + 1, H, W,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "yaik_grad_plane")
    _count(grad_plane, dev)
    return out


grad_plane.launches = 0
grad_plane.per_device = {}


def grad_plane_final_plain(corners: torch.Tensor, code4: torch.Tensor,
                           vc: torch.Tensor) -> torch.Tensor:
    """The merged gradient plane with the final composition: corners and
    code4 as grad_plane_plain, vc [(B,) H, W] i32 the composed T3 + 1D word
    with channel c's write flag in bit 24+c. The gradient word g blends
    over the 0x808080 background, p1 = g & 0xFFFFFF where g has its write
    flag, else 0x808080; vc applies under its flags' byte mask mc.
    Returns [H, W] i32, p1 ^ ((p1 ^ vc) & mc)."""
    g = grad_plane_plain(corners, code4)
    p1 = torch.where(((g >> 24) & 1) != 0, g & 0xFFFFFF, 0x808080)
    return p1 ^ ((p1 ^ vc) & _byte_mask((vc >> 24) & 7))


def grad_plane_final(corners: torch.Tensor, code4: torch.Tensor,
                     vc: torch.Tensor) -> torch.Tensor:
    """Merged gradient plane and final composition (see
    grad_plane_final_plain); corners [7, H/4+1, W/4+1] i32, code4
    [H/4, W/4] u8, vc [H, W] i32, all contiguous on one device; or a batch
    of each, [B, ...] -> [B, H, W], one launch."""
    dev = corners.device
    lead, hq, wq = _grad_geometry(corners, code4)
    H, W = hq * 4, wq * 4
    _expect(vc, "vc", torch.int32, lead + (H, W), dev)
    if not _route(dev):
        return grad_plane_final_plain(corners, code4, vc)
    out = torch.empty(lead + (H, W), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = build.library().yaik_grad_plane_final(
            corners.data_ptr(), code4.data_ptr(), ctypes.addressof(_SHIFTS),
            vc.data_ptr(), out.data_ptr(), math.prod(lead), hq + 1, wq + 1,
            H, W,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "yaik_grad_plane_final")
    _count(grad_plane_final, dev)
    return out


grad_plane_final.launches = 0
grad_plane_final.per_device = {}


def tile_to_image(v: torch.Tensor, nty: int, ntx: int) -> torch.Tensor:
    """[..., nty*ntx, 16] 4x4-block-major -> [..., nty*4, ntx*4] image
    order."""
    lead = v.shape[:-2]
    return v.reshape(*lead, nty, ntx, 4, 4).transpose(-3, -2).reshape(
        *lead, nty * 4, ntx * 4)


def d1_block_vals(prm: torch.Tensor, codes4: torch.Tensor,
                  wm2: torch.Tensor) -> torch.Tensor:
    """The 1D residual pass in 4x4-block space (jax_engine._d1_vals_tile):
    prm [5, G4] i32 (colour0 and base packed c0|c1<<8|c2<<16, then d2 per
    channel), codes4 [12, G4] i32 (channel c's code byte of pixel p is byte
    p&3 of row 4c+p>>2), wm2 [2, G4] i32 (channel c's write bit of pixel p
    is bit c*16+p of the pair) -> [G4, 16] i32: per channel
    L != 0 ? (base + (((L-1) * d2) >> 16)) & 0xFF : c0, with channel c's
    write bit in bit 24+c. A batch, prm [5, B, G4] and so on, gives
    [B, G4, 16]."""
    lead = prm.shape[1:-1]
    prm, codes4, wm2 = (x.reshape(x.shape[0], -1) for x in (prm, codes4, wm2))
    G = prm.shape[1]
    dev = prm.device
    sh8 = torch.arange(0, 32, 8, device=dev, dtype=torch.int32)
    chan = sh8[:3, None, None]                                # [3, 1, 1]
    # L[c, p, g]: channel c's code byte of pixel p (byte p&3 of row 4c+p>>2)
    L = ((codes4.reshape(3, 4, 1, G) >> sh8[None, None, :, None]) & 0xFF
         ).reshape(3, 16, G)
    c0 = (prm[0] >> chan) & 0xFF
    base = (prm[1] >> chan) & 0xFF
    d2 = prm[2:5, None, :]
    v = torch.where(L != 0, (base + (((L - 1) * d2) >> 16)) & 0xFF, c0)
    # write bit of (c, p) is bit c*16+p of the 64-bit pair wm2[0], wm2[1]
    words = torch.stack([wm2[0] & 0xFFFF, (wm2[0] >> 16) & 0xFFFF,
                         wm2[1] & 0xFFFF])[:, None, :]        # [3, 1, G]
    bit = torch.arange(16, device=dev, dtype=torch.int32)[None, :, None]
    w = (words >> bit) & 1                                    # [3, 16, G]
    return (v[0] | (v[1] << 8) | (v[2] << 16)
            | (w[0] << 24) | (w[1] << 25) | (w[2] << 26)).T.reshape(
                *lead, -1, 16)                                # [..., G, 16]


def _resolve_plain(tab: torch.Tensor, idx: torch.Tensor, cols: torch.Tensor,
                   accept: torch.Tensor, rows: torch.Tensor):
    """Per pixel of LUT tiles: (v, w) i32. idx [..., P] raw idx | wmask<<6
    bytes, cols [..., 6] min/max RGB, accept [...] and rows [...] per tile
    (rows clamped into the table). v = the tile's colours through entry
    e = tab[row][idx & 63], (mn + ((mx - mn) * e_c >> 7)) & 0xFF per
    channel; w = wmask * accept."""
    C = tab.shape[0]
    b = idx.to(torch.int32)
    r = rows.to(torch.int64).clamp(0, C - 1)
    e = tab.reshape(-1)[r[..., None] * 64 + (b & 63).to(torch.int64)]
    c = cols.to(torch.int32)
    v = torch.zeros_like(e)
    for ch in range(3):
        mn = c[..., ch:ch + 1]
        d = c[..., 3 + ch:4 + ch] - mn
        v |= ((mn + ((d * ((e >> (8 * ch)) & 0xFF)) >> 7)) & 0xFF) << (8 * ch)
    return v, ((b >> 6) & 1) * accept.to(torch.int32)[..., None]


def _byte_mask(w: torch.Tensor) -> torch.Tensor:
    """3-bit channel masks -> 0xFF byte masks of the channels."""
    return ((w & 1) * 0xFF | ((w >> 1) & 1) * 0xFF00
            | ((w >> 2) & 1) * 0xFF0000)


def t3_merged_plain(tab: torch.Tensor, idx16: torch.Tensor,
                    cols: torch.Tensor, accept: torch.Tensor,
                    rows: torch.Tensor) -> torch.Tensor:
    """Both merged T3 layers resolved and composed, B over A.

    tab [C, 64] i32 packed LUT table; per layer L in {0, 1}: idx16[L]
    [G4, 16] u8 raw idx | wmask<<6 bytes, cols[L] [G4, 6] u8 min/max RGB,
    accept[L] [G4] u8, rows[L] [G4] i32 table rows (clamped into the
    table). Returns [G4, 16] i32: (wB ? vB : vA) | (wA | wB) << 24. A
    batch lies between the layer axis and the blocks (idx16 [2, B, G4, 16],
    cols [2, B, G4, 6], accept and rows [2, B, G4]) and gives
    [B, G4, 16]."""
    v, w = _resolve_plain(tab, idx16, cols, accept, rows)
    return torch.where(w[1] != 0, v[1], v[0]) | ((w[0] | w[1]) << 24)


def t2_merged_plain(tab: torch.Tensor, idx16: torch.Tensor,
                    cols: torch.Tensor, chm: torch.Tensor,
                    rows: torch.Tensor) -> torch.Tensor:
    """Both merged 2DTL layers resolved and composed per channel: operands
    as t3_merged_plain, with `chm` (each block's 3-bit written-channel
    mask) in the accept slot and rows into the tripled 2D table. Layer B
    wins only on its own channels. Returns [G4, 16] i32:
    (vA ^ ((vA ^ vB) & mB)) | (wA | wB) << 24, mB the 0xFF byte mask of
    wB's channels."""
    v, w = _resolve_plain(tab, idx16, cols, chm, rows)
    return (v[0] ^ ((v[0] ^ v[1]) & _byte_mask(w[1]))) | ((w[0] | w[1]) << 24)


def _layers(tab: torch.Tensor, idx16: torch.Tensor, cols: torch.Tensor,
            accept: torch.Tensor, rows: torch.Tensor) -> tuple:
    """(C, batch lead, G4) of the merged kernels' operands, checked: tab
    [C, 64], per layer [(B,) G4, ...]."""
    dev = tab.device
    if tab.ndim != 2 or idx16.ndim not in (3, 4) or idx16.shape[0] != 2:
        raise ValueError("tab must be [C, 64] and idx16 [2, G4, 16] or "
                         "[2, B, G4, 16]")
    lead, G = tuple(idx16.shape[1:-2]), idx16.shape[-2]
    if math.prod(lead) * G * 4 >= 2 ** 31:
        raise ValueError(f"{math.prod(lead)} x {G} blocks exceed the "
                         "kernels' 2^29-block grid")
    _expect(tab, "tab", torch.int32, (tab.shape[0], 64), dev)
    _expect(idx16, "idx16", torch.uint8, (2, *lead, G, 16), dev)
    _expect(cols, "cols", torch.uint8, (2, *lead, G, 6), dev)
    _expect(accept, "accept", torch.uint8, (2, *lead, G), dev)
    _expect(rows, "rows", torch.int32, (2, *lead, G), dev)
    return tab.shape[0], lead, G


def _merged(fn, name: str, tab: torch.Tensor, idx16: torch.Tensor,
            cols: torch.Tensor, accept: torch.Tensor, rows: torch.Tensor,
            plain) -> torch.Tensor:
    dev = tab.device
    C, lead, G = _layers(tab, idx16, cols, accept, rows)
    if not _route(dev):
        return plain(tab, idx16, cols, accept, rows)
    out = torch.empty(lead + (G, 16), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        # the layers' [2, B, G4] layout is [2, B * G4]: one launch over the
        # B * G4 blocks
        err = getattr(build.library(), name)(
            tab.data_ptr(), C, idx16.data_ptr(), cols.data_ptr(),
            accept.data_ptr(), rows.data_ptr(), math.prod(lead) * G,
            out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, name)
    _count(fn, dev)
    return out


def t3_merged(tab: torch.Tensor, idx16: torch.Tensor, cols: torch.Tensor,
              accept: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Merged T3 resolve (see t3_merged_plain); all operands contiguous
    on one device, one image or a batch."""
    return _merged(t3_merged, "yaik_t3_merged", tab, idx16, cols, accept,
                   rows, t3_merged_plain)


t3_merged.launches = 0
t3_merged.per_device = {}


def t2_merged(tab: torch.Tensor, idx16: torch.Tensor, cols: torch.Tensor,
              chm: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Merged 2DTL resolve with the per-channel compose (see
    t2_merged_plain); all operands contiguous on one device, one image or
    a batch."""
    return _merged(t2_merged, "yaik_t2_merged", tab, idx16, cols, chm, rows,
                   t2_merged_plain)


t2_merged.launches = 0
t2_merged.per_device = {}


def t3_merged_d1_plain(tab: torch.Tensor, idx16: torch.Tensor,
                       cols: torch.Tensor, accept: torch.Tensor,
                       rows: torch.Tensor, prm: torch.Tensor,
                       codes4: torch.Tensor, wm2: torch.Tensor, H: int,
                       W: int) -> torch.Tensor:
    """Both merged T3 layers composed with the 1D residual, in image
    order: T3 operands as t3_merged_plain and 1D operands as
    d1_block_vals, for the G4 = (H/4) * (W/4) blocks of an H x W image.
    Per channel the 1D value wins where its write bit is set, else the T3
    byte stands; channel c's flag, bit 24+c, is (wA | wB != 0) | w1_c.
    Returns [H, W] i32. A batch (T3 operands as t3_merged_plain's, prm
    [5, B, G4], codes4 [12, B, G4], wm2 [2, B, G4]) gives [B, H, W]: the
    image order of all B * G4 blocks, W/4 to a row, is the B images stacked
    vertically, [B * H, W], as the kernel writes it."""
    v, w = _resolve_plain(tab, idx16, cols, accept, rows)
    t3 = torch.where(w[1] != 0, v[1], v[0])
    wt = ((w[0] | w[1]) != 0).to(torch.int32) * 7
    v1 = d1_block_vals(prm, codes4, wm2)
    f1 = (v1 >> 24) & 7
    out = (t3 ^ ((t3 ^ v1) & _byte_mask(f1))) | ((wt | f1) << 24)
    lead = out.shape[:-2]
    return tile_to_image(out.reshape(-1, 16), math.prod(lead) * H // 4,
                         W // 4).reshape(*lead, H, W)


def t3_merged_d1(tab: torch.Tensor, idx16: torch.Tensor, cols: torch.Tensor,
                 accept: torch.Tensor, rows: torch.Tensor, prm: torch.Tensor,
                 codes4: torch.Tensor, wm2: torch.Tensor, H: int, W: int
                 ) -> torch.Tensor:
    """Merged T3 resolve composed with the 1D residual, in image order
    (see t3_merged_d1_plain); all operands contiguous on one device, H and
    W multiples of 4; one image, or a batch -> [B, H, W] in one launch."""
    dev = tab.device
    if H % 4 or W % 4 or min(H, W) < 0:
        raise ValueError(f"image {H}x{W} is not a multiple of 4")
    C, lead, G = _layers(tab, idx16, cols, accept, rows)
    if G != (H // 4) * (W // 4):
        raise ValueError(f"{G} blocks per image, but a {H}x{W} image has "
                         f"{(H // 4) * (W // 4)}")
    _expect(prm, "prm", torch.int32, (5, *lead, G), dev)
    _expect(codes4, "codes4", torch.int32, (12, *lead, G), dev)
    _expect(wm2, "wm2", torch.int32, (2, *lead, G), dev)
    if not _route(dev):
        return t3_merged_d1_plain(tab, idx16, cols, accept, rows, prm,
                                  codes4, wm2, H, W)
    out = torch.empty(lead + (H, W), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        # the B * G4 blocks in image order, W/4 to a row, are the B images
        # stacked vertically: [B * H, W] is [B, H, W]
        err = build.library().yaik_t3_merged_d1(
            tab.data_ptr(), C, idx16.data_ptr(), cols.data_ptr(),
            accept.data_ptr(), rows.data_ptr(), prm.data_ptr(),
            codes4.data_ptr(), wm2.data_ptr(), math.prod(lead) * G, W // 4,
            out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "yaik_t3_merged_d1")
    _count(t3_merged_d1, dev)
    return out


t3_merged_d1.launches = 0
t3_merged_d1.per_device = {}


def lut_pass_plain(tab: torch.Tensor, packed: torch.Tensor,
                   cols: torch.Tensor, chm: torch.Tensor, rows: torch.Tensor,
                   nty: int, ntx: int, th: int, tw: int, H: int, W: int
                   ) -> torch.Tensor:
    """One tile-size pass of LUT tiles, in image order.

    tab [R, 64] i32 packed table; per tile g of the row-major (nty, ntx)
    grid of th x tw tiles: packed[g] [th*tw] u8 raw idx | wmask<<6 bytes
    (row-major in the tile), cols[g] [6] u8 min/max RGB, chm[g] u8 the
    channels the tile writes (0 = not accepted), rows[g] i32 its table row
    (clamped into the table). Returns [H, W] i32: v | w << 24 with
    w = wmask * chm at every pixel where w != 0, and 0 at every other
    pixel, beyond the pass grid included. With a leading batch axis on
    packed, cols, chm and rows, [B, H, W]."""
    v, w = _resolve_plain(tab, packed, cols, chm, rows)
    lead = chm.shape[:-1]
    vals = torch.where(w != 0, v | (w << 24), 0)
    out = torch.zeros(lead + (H, W), dtype=torch.int32, device=tab.device)
    out[..., : nty * th, : ntx * tw] = vals.reshape(
        *lead, nty, ntx, th, tw).transpose(-3, -2).reshape(
            *lead, nty * th, ntx * tw)
    return out


def lut_pass(tab: torch.Tensor, packed: torch.Tensor, cols: torch.Tensor,
             chm: torch.Tensor, rows: torch.Tensor, nty: int, ntx: int,
             th: int, tw: int, H: int, W: int) -> torch.Tensor:
    """One tile-size pass in image order (see lut_pass_plain); all
    operands contiguous on one device. th and tw are powers of two >= 4,
    the tile grid lies inside the H x W image, W % 4 == 0 and
    H <= 65535. A batch (packed [B, g, th*tw], cols [B, g, 6], chm and
    rows [B, g]) gives [B, H, W] in one launch."""
    dev = tab.device
    if tab.ndim != 2:
        raise ValueError("tab must be [R, 64]")
    lead = _lead(chm, "chm", 1)
    for n, t in (("th", th), ("tw", tw)):
        if t < 4 or t & (t - 1):
            raise ValueError(f"{n} = {t} is not a power of two >= 4")
    if (nty * th > H or ntx * tw > W or W % 4 or H > 65535
            or min(nty, ntx, H, W) < 0):
        raise ValueError(f"a {nty}x{ntx} grid of {th}x{tw} tiles does not "
                         f"fit a {H}x{W} image with W % 4 == 0, H <= 65535")
    R, g = tab.shape[0], nty * ntx
    _expect(tab, "tab", torch.int32, (R, 64), dev)
    _expect(packed, "packed", torch.uint8, lead + (g, th * tw), dev)
    _expect(cols, "cols", torch.uint8, lead + (g, 6), dev)
    _expect(chm, "chm", torch.uint8, lead + (g,), dev)
    _expect(rows, "rows", torch.int32, lead + (g,), dev)
    if not _route(dev):
        return lut_pass_plain(tab, packed, cols, chm, rows, nty, ntx, th,
                              tw, H, W)
    # an image's tiles start g * th * tw bytes (a multiple of 16) after the
    # previous image's, so every image keeps the base's alignment
    if packed.data_ptr() % 4:
        raise ValueError("packed must be 4-byte aligned")
    out = torch.empty(lead + (H, W), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = build.library().yaik_lut_pass(
            tab.data_ptr(), R, packed.data_ptr(), cols.data_ptr(),
            chm.data_ptr(), rows.data_ptr(), math.prod(lead), nty, ntx,
            th.bit_length() - 1, tw.bit_length() - 1, H, W, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "yaik_lut_pass")
    _count(lut_pass, dev)
    return out


lut_pass.launches = 0
lut_pass.per_device = {}


def _round6(v: torch.Tensor) -> torch.Tensor:
    r = v >> 2
    return (r << 2) | (r >> 4)


def _round6p(v: torch.Tensor) -> torch.Tensor:
    return _round6(torch.clamp(v + 1, max=255))


def _grad_weights(t: int, dev: torch.device) -> torch.Tensor:
    """gradient.WEIGHTS[t] = 1024 - i * 1024 / t, made on the device (a
    copy from the host would synchronize the stream)."""
    return 1024 - torch.arange(t, dtype=torch.int32, device=dev) * (1024 // t)


def _grad_pass_plain(planes: torch.Tensor, claims: torch.Tensor, sx: int,
                     sy: int, reject_factor: int) -> torch.Tensor:
    """One gradient pass (`jax_scoring.gradient_pass_device`) over planes
    [B, 3, H, W] i32 and claims [B, 3, H, W] bool -> accept [B, nty, ntx]
    bool of the (1<<sx) x (1<<sy) pass; claims take the accepted tiles."""
    tw, th = 1 << sx, 1 << sy
    B, _, h, w = planes.shape
    ntx, nty = w // tw, h // th
    dev = planes.device
    # the corner grid clamps at each image's last row and column (a band's
    # halo row is its last row: jax_scoring.gradient_pass_device)
    xs = torch.arange(0, (ntx + 1) * tw, tw, device=dev).clamp(max=w - 1)
    ys = torch.arange(0, (nty + 1) * th, th, device=dev).clamp(max=h - 1)
    corners = planes[:, :, ys[:, None], xs[None, :]]   # [B, 3, nty+1, ntx+1]
    c00, c01 = corners[:, :, :nty, :ntx], corners[:, :, :nty, 1:]
    c10, c11 = corners[:, :, 1:, :ntx], corners[:, :, 1:, 1:]
    pix = planes[:, :, :nty * th, :ntx * tw].reshape(B, 3, nty, th, ntx, tw)
    pix = pix.permute(0, 1, 2, 4, 3, 5)         # [B, 3, nty, ntx, th, tw]
    lf = _grad_weights(tw, dev).reshape(1, 1, 1, 1, 1, tw)
    tf = _grad_weights(th, dev).reshape(1, 1, 1, 1, th, 1)

    def blends(a, b, c, d):
        # int32 suffices: blends peak at 255*1024*1024 + 2^19 < 2^31
        top = a[..., None, None] * lf + b[..., None, None] * (1024 - lf)
        bot = c[..., None, None] * lf + d[..., None, None] * (1024 - lf)
        num = top * tf + bot * (1024 - tf)
        return (num + ROUNDING) >> 20, num >> 20

    ok = torch.zeros((B, nty, ntx), dtype=torch.bool, device=dev)
    for rnd in (lambda v: v, _round6, _round6p):
        for bl in blends(rnd(c00), rnd(c01), rnd(c10), rnd(c11)):
            ok |= ((pix - bl).abs() <= reject_factor).all(-1).all(-1).all(1)
    origins = claims[:, :, ::th, ::tw][:, :, :nty, :ntx]
    accept = ok & ~origins.any(1)
    up = accept[:, :, None, :, None].expand(B, nty, th, ntx, tw)
    claims[:, :, :nty * th, :ntx * tw] |= up.reshape(B, 1, nty * th, ntx * tw)
    return accept


def grad_score_len(h: int, w: int) -> int:
    """G, the packed accepts' length per image: the 7 passes' grids,
    (h >> sy) * (w >> sx) each, in `swizzle.GRADIENT_PASS_ORDER`."""
    return sum((h >> sy) * (w >> sx)
               for (sx, sy) in swizzle.GRADIENT_PASS_ORDER)


def grad_score_plain(planes: torch.Tensor, claims: torch.Tensor,
                     reject_factor: int) -> torch.Tensor:
    """The encoder's gradient stage (`jax_scoring.gradient_all_device`):
    planes [B, 3, H, W] i32, claims [B, 3, H, W] bool -> the 7 passes'
    accept grids in `swizzle.GRADIENT_PASS_ORDER`, each [B, nty, ntx]
    flattened, packed as [B, G] u8 (G = grad_score_len(H, W)); each pass's
    accepted tiles are set in all 3 channels of claims, in place, before the
    next pass. One image [3, H, W] gives [G]."""
    if planes.ndim == 3:
        return grad_score_plain(planes[None], claims[None], reject_factor)[0]
    B = planes.shape[0]
    return torch.cat([
        _grad_pass_plain(planes, claims, sx, sy, reject_factor).reshape(
            B, -1).to(torch.uint8)
        for (sx, sy) in swizzle.GRADIENT_PASS_ORDER], dim=1)


def grad_score(planes: torch.Tensor, claims: torch.Tensor,
               reject_factor: int) -> torch.Tensor:
    """The gradient stage (see grad_score_plain), one launch whatever B is:
    planes [(B,) 3, H, W] i32 holding 0..255 (the kernel's int32 blends
    need it; it is not checked), claims [(B,) 3, H, W] bool, both
    contiguous on one device, reject_factor an int32 -> packed accepts
    [(B,) G] u8; claims updated in place (csrc/grad_score.cu)."""
    dev = planes.device
    lead = _lead(planes, "planes", 3)
    h, w = planes.shape[-2:]
    _expect(planes, "planes", torch.int32, lead + (3, h, w), dev)
    _expect(claims, "claims", torch.bool, lead + (3, h, w), dev)
    if not -2 ** 31 <= reject_factor < 2 ** 31:
        raise ValueError(f"reject_factor {reject_factor} is not an int32")
    # exact: a blend and a pixel both lie in 0..255, so any factor >= 255
    # accepts every blend and any factor < 0 none; the kernel's range checks
    # take [-1, 255] (span (2 rf + 1) << 20 stays an int32, -1 gives none)
    reject_factor = min(max(reject_factor, -1), 255)
    if not _route(dev):
        return grad_score_plain(planes, claims, reject_factor)
    G = grad_score_len(h, w)
    out = torch.empty(lead + (G,), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = build.library().yaik_grad_score(
            planes.data_ptr(), claims.data_ptr(), out.data_ptr(),
            math.prod(lead), h, w, G, reject_factor,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "yaik_grad_score")
    _count(grad_score, dev)
    return out


grad_score.launches = 0
grad_score.per_device = {}


# pixels per chunk of the plain versions: bounds their [pixels, E*48*8]
# and [Tc, E, P, 64] transients (the 4x4 pass of a 4K image has 8.3 M)
SCORE_CHUNK_PX = 1 << 12
VALUES_CHUNK_PX = 1 << 13


def score48_plain(c: torch.Tensor, alive: torch.Tensor, qpts: torch.Tensor
                  ) -> torch.Tensor:
    """Pattern scores (jax_scoring.tile3d_score_device): c [T, P, 3] i32
    coordinates in 0..63, alive [T, P] bool, qpts [E, 48, 8, 3] i32 ->
    sums [T, E, 48] i32, sum over alive p of min_k |c[t,p] - qpts[e,n,k]|^2.

    Distances as |c|^2 + (|q|^2 - 2 c.q), one float32 product per chunk of
    SCORE_CHUNK_PX pixels: exact, since every operand and partial sum is
    an integer below 2^24 (and c, 2q fit TF32's mantissa too)."""
    T, P, _ = c.shape
    E = qpts.shape[0]
    q = qpts.reshape(E * 48 * 8, 3).float()
    qm, q2 = -2.0 * q.T, (q * q).sum(-1)
    tc = max(1, SCORE_CHUNK_PX // P)
    out = []
    for t0 in range(0, T, tc):
        cf = c[t0:t0 + tc].reshape(-1, 3).float()            # [Tc*P, 3]
        d = torch.addmm(q2, cf, qm).reshape(-1, E * 48, 8).amin(-1)
        m = (d + (cf * cf).sum(-1, keepdim=True)).to(torch.int32)
        m = torch.where(alive[t0:t0 + tc].reshape(-1, 1), m, 0)
        out.append(m.reshape(-1, P, E * 48).sum(1, dtype=torch.int32))
    return torch.cat(out).reshape(T, E, 48)


def pattern_argmin(sums: torch.Tensor) -> torch.Tensor:
    """mode48 [T, E] i32 of sums [T, E, 48]: the first pattern of least
    score, as the reference's strict-< scan picks it (torch.argmin returns
    the first index of the minimum)."""
    return sums.argmin(-1).to(torch.int32)


def score48_mode_plain(c: torch.Tensor, alive: torch.Tensor,
                       qpts: torch.Tensor) -> torch.Tensor:
    """The pattern of each (tile, LUT): operands as score48_plain ->
    mode48 [T, E] i32, the pattern_argmin of its sums."""
    return pattern_argmin(score48_plain(c, alive, qpts))


def _score(fn, name: str, plain, c: torch.Tensor, alive: torch.Tensor,
           qpts: torch.Tensor, out_shape) -> torch.Tensor:
    dev = c.device
    if c.ndim != 3 or qpts.ndim != 4:
        raise ValueError("c must be [T, P, 3] and qpts [E, 48, 8, 3]")
    T, P, E = c.shape[0], c.shape[1], qpts.shape[0]
    _expect(c, "c", torch.int32, (T, P, 3), dev)
    _expect(alive, "alive", torch.bool, (T, P), dev)
    _expect(qpts, "qpts", torch.int32, (E, 48, 8, 3), dev)
    if not _route(dev):
        return plain(c, alive, qpts)
    if P < 1 or P > 512 or P & (P - 1):
        raise ValueError(f"tile size {P} is not a power of two <= 512")
    out = torch.empty(out_shape(T, E), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = getattr(build.library(), name)(
            c.data_ptr(), alive.data_ptr(), qpts.data_ptr(), T, P, E,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, name)
    _count(fn, dev)
    return out


def score48(c: torch.Tensor, alive: torch.Tensor, qpts: torch.Tensor
            ) -> torch.Tensor:
    """48-pattern tile scores (see score48_plain); all operands contiguous
    on one device. P must be a power of two <= 512."""
    return _score(score48, "yaik_score48", score48_plain, c, alive, qpts,
                  lambda T, E: (T, E, 48))


score48.launches = 0
score48.per_device = {}


def score48_mode(c: torch.Tensor, alive: torch.Tensor, qpts: torch.Tensor
                 ) -> torch.Tensor:
    """mode48 [T, E] i32, the first pattern of least score (see
    score48_mode_plain), without the [T, E, 48] sums; operands as
    score48."""
    return _score(score48_mode, "yaik_score48_mode", score48_mode_plain, c,
                  alive, qpts, lambda T, E: (T, E))


score48_mode.launches = 0
score48_mode.per_device = {}

# values48's four bit-depth windows: (step into pts, points); window bi
# takes factors[3 - bi]
V48_WINDOWS = ((1, 64), (2, 32), (4, 16), (8, 8))
_V48_SKIP = 4
_V48_INIT = 1215752191                 # (int)99999999999, EncoderContext:6459
_SWAP3D = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


def _values_chunk(tiles, alive, a_c, b_c, mode48, mn, d, sf, ff):
    """values48_plain on one chunk of tiles (same operands, sf/ff the
    packed [E, 120, 3] window points (f32) and factors (i32))."""
    Tc, P, _ = tiles.shape
    E = mode48.shape[1]
    dev = tiles.device
    flip = torch.stack([(mode48 >> s) & 1 for s in range(3)], -1)  # Tc,E,3
    perm = torch.tensor(_SWAP3D, device=dev)[(mode48 >> 3).long()]
    perm = perm[:, :, None, :].expand(Tc, E, P, 3)
    m_s = torch.where(flip[:, :, None, :] == 1, b_c[:, None], a_c[:, None])
    mf = torch.gather(m_s, 3, perm).float()                     # Tc,E,P,3
    e_rows = torch.arange(E, device=dev)[None, :, None]
    acc_mode = torch.full((Tc, E), _V48_SKIP, dtype=torch.int32, device=dev)
    diff_sel = torch.zeros((Tc, E), dtype=torch.int32, device=dev)
    idx_by_bit = []
    off = 0
    for bi, (_, npts) in enumerate(V48_WINDOWS):
        s = sf[:, off:off + npts]                                # E, n, 3
        # ((d0^2 + d1^2) + d2^2) in float32, the XLA form's op order
        dd = [mf[..., o, None] - s[None, :, None, :, o] for o in range(3)]
        db = (dd[0] * dd[0] + dd[1] * dd[1]) + dd[2] * dd[2]    # Tc,E,P,n
        idx = db.argmin(-1)                                      # first min
        idx_by_bit.append(idx)
        f = ff[:, off:off + npts][e_rows, idx]                   # Tc,E,P,3
        off += npts
        fxs = torch.where(flip[:, :, None, :] == 1, 128 - f, f)
        fx = torch.gather(fxs, 3, perm)
        recon = mn[:, None, None, :] + ((fx * d[:, None, None, :]) >> 7)
        ld = (recon - tiles[:, None]).abs().amax(-1)             # Tc,E,P
        ldiff = torch.where(alive[:, None], ld, 0)
        ok = (ldiff > 5).sum(-1) <= 3
        acc_mode = torch.where(ok, 3 - bi, acc_mode)
        diff_sel = torch.where(ok, ldiff.sum(-1, dtype=torch.int32),
                               diff_sel)
    # the LUT scan: a later LUT wins ties
    best_diff = torch.full((Tc,), _V48_INIT, dtype=torch.int32, device=dev)
    best_e = torch.full((Tc,), -1, dtype=torch.int32, device=dev)
    for e in range(E):
        ok = (acc_mode[:, e] != _V48_SKIP) & (diff_sel[:, e] <= best_diff)
        best_diff = torch.where(ok, diff_sel[:, e], best_diff)
        best_e = torch.where(ok, e, best_e)
    e_sel = best_e.clamp(min=0).long()
    rows = torch.arange(Tc, device=dev)
    bitmode = acc_mode[rows, e_sel].clamp(max=3)
    tile_type = mode48[rows, e_sel] | (e_sel.int() << 6) | (bitmode << 14)
    idx = torch.stack(idx_by_bit)[(3 - bitmode).long(), rows, e_sel]
    return best_e >= 0, tile_type, idx.int()


def values48_plain(tiles: torch.Tensor, alive: torch.Tensor,
                   a_c: torch.Tensor, b_c: torch.Tensor, mode48: torch.Tensor,
                   mn: torch.Tensor, d: torch.Tensor, pts: torch.Tensor,
                   factors: torch.Tensor):
    """The encoder's values stage (jax_scoring.tile3d_values_device):
    computeValues3D for every (tile, LUT) and the LUT scan.

    tiles [T, P, 3] i32, alive [T, P] bool, a_c/b_c [T, P, 3] i32 (the two
    normalizations), mode48 [T, E] i32 in 0..47, mn/d [T, 3] i32, pts
    [E, 64, 3] i32, factors [4, E, 64, 3] i32 -> (accept [T] bool,
    tile_type [T] i32, idx [T, P] i32). In chunks of VALUES_CHUNK_PX
    pixels."""
    T, P, _ = tiles.shape
    sf = torch.cat([pts[:, ::st][:, :n] for st, n in V48_WINDOWS],
                   1).float()                                    # E, 120, 3
    ff = torch.cat([factors[3 - bi][:, :n]
                    for bi, (_, n) in enumerate(V48_WINDOWS)], 1)
    tc = max(1, VALUES_CHUNK_PX // P)
    parts = [_values_chunk(*(x[t0:t0 + tc] for x in (
        tiles, alive, a_c, b_c, mode48, mn, d)), sf, ff)
        for t0 in range(0, T, tc)]
    return tuple(torch.cat(x) for x in zip(*parts))


def values48(tiles: torch.Tensor, alive: torch.Tensor, a_c: torch.Tensor,
             b_c: torch.Tensor, mode48: torch.Tensor, mn: torch.Tensor,
             d: torch.Tensor, pts: torch.Tensor, factors: torch.Tensor):
    """The values stage (see values48_plain); all operands contiguous on
    one device. P must be a power of two <= 256 and E <= 128 (the Pallas
    kernel's limit), and every point of `pts` must lie in 0..255, as the
    bank's u8 points do (`bank.load_bank_file` reads them as u8): the
    kernel's integer search is exact there. One call runs three CUDA kernels (table
    packing, the decision, every pixel's idx) and adds one to `launches`."""
    dev = tiles.device
    if tiles.ndim != 3 or mode48.ndim != 2:
        raise ValueError("tiles must be [T, P, 3] and mode48 [T, E]")
    T, P, E = tiles.shape[0], tiles.shape[1], mode48.shape[1]
    for name, t, dt, shape in (
            ("tiles", tiles, torch.int32, (T, P, 3)),
            ("alive", alive, torch.bool, (T, P)),
            ("a_c", a_c, torch.int32, (T, P, 3)),
            ("b_c", b_c, torch.int32, (T, P, 3)),
            ("mode48", mode48, torch.int32, (T, E)),
            ("mn", mn, torch.int32, (T, 3)),
            ("d", d, torch.int32, (T, 3)),
            ("pts", pts, torch.int32, (E, 64, 3)),
            ("factors", factors, torch.int32, (4, E, 64, 3))):
        _expect(t, name, dt, shape, dev)
    if not _route(dev):
        return values48_plain(tiles, alive, a_c, b_c, mode48, mn, d, pts,
                              factors)
    if P < 1 or P > 256 or P & (P - 1):
        raise ValueError(f"tile size {P} is not a power of two <= 256")
    if E > 128:
        raise ValueError(f"{E} LUTs exceed the kernel's limit of 128")
    scratch = torch.empty((2, E, 120, 4), dtype=torch.int32, device=dev)
    accept = torch.empty(T, dtype=torch.bool, device=dev)
    tile_type = torch.empty(T, dtype=torch.int32, device=dev)
    idx = torch.empty((T, P), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = build.library().yaik_values48(
            tiles.data_ptr(), alive.data_ptr(), a_c.data_ptr(),
            b_c.data_ptr(), mode48.data_ptr(), mn.data_ptr(), d.data_ptr(),
            pts.data_ptr(), factors.data_ptr(), scratch.data_ptr(), T, P,
            E, accept.data_ptr(), tile_type.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "yaik_values48")
    _count(values48, dev)
    return accept, tile_type, idx


values48.launches = 0
values48.per_device = {}


# (candidates, tiles) per chunk of the covers plain versions: bounds their
# [kc, nc, 64 px, 64 pt] i32 distance transients (~3 such tensors live) to
# ~0.8 GB, whatever k and n are
COVERS_CHUNK = (8, 2048)
COVERS_PAD = 4096          # a 2D candidate's pad point coordinate


def _covers_plain(cands: torch.Tensor, cmask, tiles: torch.Tensor, tmask,
                  gate: int, chunk: tuple) -> torch.Tensor:
    """The coverage matrix [k, n] bool of cands [k, 64, D] against tiles
    [n, 64, D] (both i32), chunk by chunk: tile t is covered by candidate c
    when at most 3 of its counted pixels (tmask, or all) have a squared
    nearest-point distance above `gate`; pad points of a candidate (cmask
    0) sit at (COVERS_PAD, COVERS_PAD)."""
    if cmask is not None:
        cands = torch.where(cmask[..., None], cands, COVERS_PAD)
    k, n, D = cands.shape[0], tiles.shape[0], cands.shape[2]
    kc, nc = chunk
    out = torch.empty((k, n), dtype=torch.bool, device=cands.device)
    for i in range(0, k, kc):
        c = cands[i:i + kc]
        for j in range(0, n, nc):
            t = tiles[j:j + nc]
            d = None
            for a in range(D):
                e = t[None, :, :, None, a] - c[:, None, None, :, a]
                d = e * e if d is None else d + e * e
            viol = d.amin(-1) > gate                       # [kc, nc, 64]
            if tmask is not None:
                viol &= tmask[None, j:j + nc]
            out[i:i + kc, j:j + nc] = viol.sum(-1) <= 3
    return out


def covers_plain(cands: torch.Tensor, tiles: torch.Tensor, gate_px: int = 75,
                 chunk: tuple = COVERS_CHUNK) -> torch.Tensor:
    """The 3D coverage matrix (`mining._covers_device`): cands [k, 64, 3],
    tiles [n, 64, 3], u8 or i32 -> [k, n] bool, True where at most 3 of a
    tile's 64 pixels have a squared nearest-point distance to the
    candidate's cloud above gate_px. `chunk` (candidates, tiles) bounds the
    transient."""
    return _covers_plain(cands.to(torch.int32), None, tiles.to(torch.int32),
                         None, gate_px, chunk)


def covers2d_plain(cands: torch.Tensor, cand_mask: torch.Tensor,
                   tiles: torch.Tensor, tile_mask: torch.Tensor,
                   gate: int = 36, chunk: tuple = COVERS_CHUNK
                   ) -> torch.Tensor:
    """The 2D coverage matrix (`mining._covers2d_device`): point sets
    padded to 64, cands [k, 64, 2] with cand_mask [k, 64] bool (pad points
    sit at (4096, 4096), whatever their slots hold), tiles [n, 64, 2] with
    tile_mask [n, 64] bool (pad pixels are not counted), u8 or i32
    coordinates in 0..4096, in any layout of live and pad slots -> [k, n]
    bool: tile t is covered by candidate c when at most 3 of its counted
    pixels have a squared nearest-point distance above `gate` (an int32).
    Every distance in int32, over all 64 slots of both."""
    return _covers_plain(cands.to(torch.int32), cand_mask,
                         tiles.to(torch.int32), tile_mask, gate, chunk)


# counted pixels a batch of the 2D kernel: 32 lanes x 16 (csrc/covers.cu
# CAP)
COVERS2D_CAP = 512


def covers2d_plan(tile_mask: torch.Tensor, cap: int = COVERS2D_CAP
                  ) -> tuple:
    """The 2D kernel's batch plan, torch ops on the mask's device with no
    host sync. The tiles' counted pixels, in tile and slot order, make one
    stream, cut into batches of `cap`: tile_mask [n, 64] bool -> (starts
    [n + 1] i32: tile t's counted pixels are the stream's slots starts[t]
    .. starts[t + 1] - 1, starts[n] their total; tfirst [n * 64 // cap + 2]
    i32: tfirst[b] is the first tile t with starts[t] >= b * cap, or n).
    Batch b takes the slots b * cap .. min((b + 1) * cap, starts[n]) - 1,
    the tiles tfirst[b] .. tfirst[b + 1] - 1 that start there and the one
    that runs into it."""
    if cap < 64:
        raise ValueError(f"cap {cap} is below a tile's 64 pixels")
    n, dev = tile_mask.shape[0], tile_mask.device
    starts = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    torch.cumsum(tile_mask.sum(1, dtype=torch.int32), 0, out=starts[1:])
    lows = torch.arange(n * 64 // cap + 2, dtype=torch.int32,
                        device=dev) * cap
    tfirst = torch.searchsorted(starts[:n], lows, out_int32=True)
    return starts, tfirst


def _cover_operands(D: int, cands, cmask, tiles, tmask, gate: int) -> None:
    """Raise unless the operands are cands [k, 64, D] and tiles [n, 64, D]
    (u8 or i32), the masks (2D) bool [k, 64] and [n, 64], contiguous, all
    on one device, and gate an int32."""
    dev = cands.device
    if cands.ndim != 3 or tiles.ndim != 3:
        raise ValueError(f"cands and tiles must be [k, 64, {D}] and "
                         f"[n, 64, {D}]")
    k, n = cands.shape[0], tiles.shape[0]
    for t, name, rows in ((cands, "cands", k), (tiles, "tiles", n)):
        if t.dtype not in (torch.uint8, torch.int32):
            raise TypeError(f"{name} has dtype {t.dtype}, expected uint8 "
                            "or int32")
        if tuple(t.shape) != (rows, 64, D) or t.device != dev:
            raise ValueError(f"{name} is {tuple(t.shape)} on {t.device}, "
                             f"expected ({rows}, 64, {D}) on {dev}")
    if cmask is not None:
        _expect(cmask, "cand_mask", torch.bool, (k, 64), dev)
        _expect(tmask, "tile_mask", torch.bool, (n, 64), dev)
    if not -2 ** 31 <= gate < 2 ** 31:
        raise ValueError(f"gate {gate} is not an int32")


def _aligned(t: torch.Tensor, align: int) -> torch.Tensor:
    """`t`, or a copy of it where its data does not start on `align`
    bytes."""
    return t if t.data_ptr() % align == 0 else t.clone()


def covers(cands: torch.Tensor, tiles: torch.Tensor, gate_px: int = 75
           ) -> torch.Tensor:
    """The 3D coverage matrix (see covers_plain): cands [k, 64, 3], tiles
    [n, 64, 3], u8 or i32, on one device -> [k, n] bool, one launch."""
    _cover_operands(3, cands, None, tiles, None, gate_px)
    dev = cands.device
    if not _route(dev):
        return _covers_plain(cands.to(torch.int32), None,
                             tiles.to(torch.int32), None, gate_px,
                             COVERS_CHUNK)
    k, n = cands.shape[0], tiles.shape[0]
    c = cands.to(torch.int32).contiguous()
    t = tiles.to(torch.int32).contiguous()
    out = torch.empty((k, n), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        err = build.library().yaik_covers(
            c.data_ptr(), t.data_ptr(), k, n, gate_px, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "yaik_covers")
    _count(covers, dev)
    return out


covers.launches = 0
covers.per_device = {}


def covers2d(cands: torch.Tensor, cand_mask: torch.Tensor,
             tiles: torch.Tensor, tile_mask: torch.Tensor, gate: int = 36
             ) -> torch.Tensor:
    """The 2D coverage matrix (see covers2d_plain); all operands on one
    device, the masks contiguous -> [k, n] bool, one launch. On the card
    the kernel computes each live point of a candidate against each
    counted pixel of a tile only (in the batches of `covers2d_plan`), one
    dp2a a distance where the candidates' points lie in 0..255 (u8) and
    the pixels in 0..16383, else in int32; bit-equal to covers2d_plain
    either way (csrc/covers.cu)."""
    _cover_operands(2, cands, cand_mask, tiles, tile_mask, gate)
    dev = cands.device
    if not _route(dev):
        return _covers_plain(cands.to(torch.int32), cand_mask,
                             tiles.to(torch.int32), tile_mask, gate,
                             COVERS_CHUNK)
    k, n = cands.shape[0], tiles.shape[0]
    # the kernel reads a point as 8 bytes and a tile's mask as 16-byte words
    c = _aligned(cands.to(torch.int32).contiguous(), 8)
    t = _aligned(tiles.to(torch.int32).contiguous(), 8)
    tile_mask = _aligned(tile_mask, 16)
    out = torch.empty((k, n), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        starts, tfirst = covers2d_plan(tile_mask)
        nb = tfirst.numel() - 1
        scratch = torch.zeros(k * nb, dtype=torch.int32, device=dev)
        err = build.library().yaik_covers2d(
            c.data_ptr(), cand_mask.data_ptr(), t.data_ptr(),
            tile_mask.data_ptr(), starts.data_ptr(), tfirst.data_ptr(),
            scratch.data_ptr(), k, n, nb, COVERS2D_CAP, gate,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "yaik_covers2d")
    _count(covers2d, dev)
    return out


covers2d.launches = 0
covers2d.per_device = {}
