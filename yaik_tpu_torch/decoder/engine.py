"""Device decode of any stream, in PyTorch.

`decode_core` is `yaik_tpu.decoder.jax_engine.decode_core` (:800-923) on the
port's operands (`pack.DecodeArgs`). The whole image lives in one int32 word
per pixel, r | g<<8 | b<<16, and every stage applies as a masked bitwise
blend `plane ^= (plane ^ vals) & mask`, in this order:

1. the plane starts at 0x808080;
2. the UCOL/SMAP overlay (torch ops);
3. the merged all-plane gradient plane (`kernels.grad_plane`), under its
   bit-24 write flag, over the current plane;
4. T3: both merged layers (`kernels.t3_merged`, relaid from 4x4-block order
   to image order), or the six size passes (`kernels.lut_pass`, image
   order), later passes winning;
5. the plane-gradient pairs, masks 5, 3, 6 (`kernels.grad_plane` with the
   pass in the 4x4 slot), each under its planes;
6. 2DTL: both merged layers (`kernels.t2_merged`) or the six passes
   (`kernels.lut_pass` on the tripled 2D table), each under its planes;
7. the plane-gradient singles, masks 1, 2, 4;
8. the 1D residual (torch ops): composed into the merged T3 values in one
   blend when nothing stands between T3 and 1D (no stage 5-7), else its
   own blend after stage 7;
9. alpha (`decoder/alpha.py`) joins bits 24-31; the bytes of each word,
   little-endian, are the RGB(A) pixel.

A standard stream (stages 1, 3, 4 merged, 8 composed) launches exactly the
kernels and torch ops of the standard branch. Where the 1D residual composes
into merged T3, two keywords choose the fused forms of that branch, as
`YAIK_T3_D1` and `YAIK_GRAD_FINAL` do in the JAX package (both off by
default there and here):
- `t3_d1`: one `kernels.t3_merged_d1` launch resolves both T3 layers and
  applies the 1D residual per channel, in image order, in place of
  `t3_merged`, the relayouts and the 1D torch ops;
- `grad_final` (with no UCOL/SMAP overlay, since the kernel starts from the
  0x808080 background): `kernels.grad_plane_final` writes the finished
  plane, the gradient blend and the composed T3 + 1D apply in its epilogue,
  in place of `grad_plane` and both blends.
With both, a standard stream decodes in these two launches and the byte
view. Elsewhere the keywords change nothing. torch has no shifts on
uint32, so the plane is int32. `>>` on int32 is arithmetic: every shift of
a word that could carry bit 31 is masked after.

A batch of B streams (`pack.stack_args`) runs the same stages on a
[B, H, W] plane, each kernel launched once for the whole batch (the JAX
package vmaps `decode_core` instead): the blends and masks are
elementwise, and the relayouts see B * H/4 block rows.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from yaik_tpu_torch.decoder import planner as plannermod
from yaik_tpu_torch.decoder import alpha as alphamod
from yaik_tpu_torch.decoder import pack
from yaik_tpu_torch.ops import kernels
from yaik_tpu_torch.ops.kernels import tile_to_image
from yaik_tpu_torch.utils import profiler

_K22 = pack.GRAD_SHIFTS.index((2, 2))      # the 4x4 gradient slot


def device_of(device) -> torch.device:
    """torch.device of `device`; raises when CUDA is asked for and absent
    (the port never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class _Default(str):
    """The `device` default of the entry points that also take `devices=`:
    equal to "cuda", and told apart from a caller's own "cuda" by
    identity."""


CARD = _Default("cuda")


def devices_of(device, devices) -> list[torch.device]:
    """The devices a call splits its work over: `devices`, each checked
    as `device_of` checks it (one device may be listed more than once),
    or `[device]` when `devices` is None. Passing both raises."""
    if devices is None:
        return [device_of(device)]
    if device is not CARD:
        raise ValueError("pass device= or devices=, not both")
    devs = [device_of(d) for d in devices]
    if not devs:
        raise ValueError("devices= lists no device")
    return devs


@dataclass(frozen=True)
class Tables:
    """A bank's LUT tables: the host `LutTable`s the packer reads and their
    device tensors. `tab` [C, 64] i32 the 3D table; `lut2` / `tab2` the 2D
    table and its mode-shifted tripled form [3 * C2, 64] i32 (None for a
    bank without a 2D LUT)."""
    lut: pack.LutTable
    tab: torch.Tensor
    lut2: pack.LutTable | None = None
    tab2: torch.Tensor | None = None

    @classmethod
    def build(cls, expanded: dict, expanded2d: dict | None, device
              ) -> "Tables":
        dev = device_of(device)
        lut = pack.lut_table(expanded)
        if expanded2d is None:
            return cls(lut, to_card(lut.tab, dev))
        lut2 = pack.lut2d_table(expanded2d)
        return cls(lut, to_card(lut.tab, dev), lut2,
                   to_card(pack.lut2d_table3(lut2), dev))


def to_card(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor on `device`: every host-to-device copy of
    the port goes through here, counted as `h2d_bytes` and `h2d_copies`
    while a profile records (the bytes a copy to the CPU would move, too)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if profiler.on():
        profiler.count("h2d_bytes", t.numel() * t.element_size())
        profiler.count("h2d_copies")
    return t.to(device)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host (waiting for the device that
    writes it): every device-to-host copy of the port goes through here,
    counted as `d2h_bytes` and `d2h_copies` while a profile records."""
    if profiler.on():
        profiler.count("d2h_bytes", t.numel() * t.element_size())
        profiler.count("d2h_copies")
    return t.cpu().numpy()


def upload(args: pack.DecodeArgs, device) -> pack.DecodeArgs:
    """The same operands as torch tensors on `device`."""
    dev = device_of(device)
    with profiler.stage("decode:upload"):
        return args.map(lambda a: to_card(a, dev))


def channel_mask(v: torch.Tensor) -> torch.Tensor:
    """Per-channel write bits 24, 25, 26 -> 0xFF byte masks."""
    return (((v >> 24) & 1) * 0xFF | ((v >> 25) & 1) * 0xFF00
            | ((v >> 26) & 1) * 0xFF0000)


def plane_mask(mask: int) -> int:
    """GTIL plane mask (bit p = channel p) -> its 0xFF byte mask."""
    return sum(0xFF << (8 * p) for p in range(3) if mask & (1 << p))


def blend(plane: torch.Tensor, v: torch.Tensor, m) -> torch.Tensor:
    """The bits of `v` under `m` over `plane`."""
    return plane ^ ((plane ^ v) & m)


def d1_vals(prm: torch.Tensor, codes4: torch.Tensor, wm2: torch.Tensor,
            h8: int, w8: int):
    """The 1D residual pass (jax_engine._d1_vals): image-order values
    [(B,) h8, w8] i32 with per-channel write bits in bits 24-26, and the
    per-channel 0xFF write mask. Operands as in pack.pack_d1_blocks."""
    img = tile_to_image(kernels.d1_block_vals(prm, codes4, wm2), h8 // 4,
                        w8 // 4)
    return img, channel_mask(img)


def salt_d1_color0(prm: torch.Tensor, s) -> torch.Tensor:
    """A bench hook, the counterpart of `jax_engine.salt_d1_color0`: a new
    d1_prm (`pack.pack_d1_blocks`) with every channel's color0 byte raised
    by `s` mod 256 (an int, or an integer tensor that broadcasts), so that
    each step of a timed chain decodes operands that depend on the step
    before. Row 0 holds c0 | c1<<8 | c2<<16; it is rewritten with bits
    24-31 zeroed, as the JAX hook writes it, and rows 1-4 are kept. The row
    axis comes first in the port's layouts: [5, G4] for one stream,
    [5, B, G4] for a batch (`stack_args`, whose 1D operands are
    `DecodeArgs.ROW_FIRST`), where the JAX package's batch is [B, 5, G4]."""
    p0 = prm[0:1]
    nb = ((((p0 & 0xFF) + s) & 0xFF)
          | ((((p0 >> 8) & 0xFF) + s) & 0xFF) << 8
          | ((((p0 >> 16) & 0xFF) + s) & 0xFF) << 16)
    return torch.cat([nb.to(prm.dtype), prm[1:]])


def lut_passes(plane: torch.Tensor, tab: torch.Tensor, passes) -> torch.Tensor:
    """Apply `pack.LutPass`es (on `tab`) in order, each under its tiles'
    channels; a None pass is absent. `plane` [(B,) H, W], the passes'
    operands with the same batch axis."""
    h8, w8 = plane.shape[-2:]
    for p in passes:
        if p is None:
            continue
        (sx, sy), (nty, ntx) = p.shift, p.grid
        v = kernels.lut_pass(tab, p.packed, p.cols, p.chm, p.rows, nty, ntx,
                             1 << sy, 1 << sx, h8, w8)
        plane = blend(plane, v, channel_mask(v))
    return plane


def plane_grads(plane: torch.Tensor, slots, masks) -> torch.Tensor:
    """Apply plane-variant 4x4 gradient passes (`pack.PlaneGrad`, None for
    an absent mask) in order, each under its planes, through grad_plane
    with the pass in the 4x4 slot."""
    c7 = None
    for g, mask in zip(slots, masks):
        if g is None:
            continue
        if c7 is None:
            lead, q = g.corners.shape[:-2], g.corners.shape[-2:]
            c7 = torch.zeros((*lead, 7, *q), dtype=torch.int32,
                             device=plane.device)
        c7[..., _K22, :, :] = g.corners
        v = kernels.grad_plane(c7, g.code4)
        plane = blend(plane, v, ((v >> 24) & 1) * plane_mask(mask))
    return plane


def decode_core(args: pack.DecodeArgs, tables: Tables, t3_d1: bool = False,
                grad_final: bool = False) -> torch.Tensor:
    """Operands on one device (`upload`) and the bank's `Tables` there ->
    [H, W, 3] u8 pixels ([H, W, 4] with alpha) on that device, or
    [B, H, W, 3|4] for a batch. `t3_d1` and `grad_final` choose the fused
    forms (module docstring)."""
    h8, w8 = args.height, args.width
    lead = () if args.batch is None else (args.batch,)
    pgrad = args.pgrad or (None,) * 6
    t2 = args.t2_layers is not None or args.t2_passes is not None
    compose_d1 = args.idx16 is not None and args.pgrad is None and not t2
    fuse_final = grad_final and compose_d1 and args.overlay is None
    if not fuse_final:                   # else grad_plane_final writes it all
        plane = torch.full(lead + (h8, w8), 0x808080, dtype=torch.int32,
                           device=tables.tab.device)
        if args.overlay is not None:
            ov = args.overlay
            plane = blend(plane, ov, ((ov >> 24) & 1) * 0xFFFFFF)
        g = kernels.grad_plane(args.corners, args.code4)
        plane = blend(plane, g, ((g >> 24) & 1) * 0xFFFFFF)
    if compose_d1 and t3_d1:
        v = kernels.t3_merged_d1(tables.tab, args.idx16, args.cols,
                                 args.accept, args.rows, args.d1_prm,
                                 args.d1_codes4, args.d1_wm2, h8, w8)
        m = None if fuse_final else channel_mask(v)
    elif args.idx16 is not None:
        v = tile_to_image(kernels.t3_merged(tables.tab, args.idx16,
                                            args.cols, args.accept,
                                            args.rows), h8 // 4, w8 // 4)
        m = ((v >> 24) & 1) * 0xFFFFFF
        if compose_d1:
            v1, m1 = d1_vals(args.d1_prm, args.d1_codes4, args.d1_wm2, h8, w8)
            v = v ^ ((v ^ v1) & m1)          # the 1D residual wins where it writes
            m = m | m1
            if fuse_final:                   # the flags grad_plane_final reads
                v = (v & 0xFFFFFF) | (((m & 1) << 24) | ((m & 0x100) << 17)
                                      | ((m & 0x10000) << 10))
    else:
        plane = lut_passes(plane, tables.tab, args.t3_passes)
    if fuse_final:
        plane = kernels.grad_plane_final(args.corners, args.code4, v)
    elif args.idx16 is not None:
        plane = blend(plane, v, m)
    plane = plane_grads(plane, pgrad[:3], pack.PGRAD_PAIRS)
    if t2 and tables.tab2 is None:
        raise ValueError("2DTL operands but no 2D LUT table")
    if args.t2_layers is not None:
        lay = args.t2_layers
        v2 = tile_to_image(kernels.t2_merged(tables.tab2, lay.idx16, lay.cols,
                                             lay.accept, lay.rows),
                           h8 // 4, w8 // 4)
        plane = blend(plane, v2, channel_mask(v2))
    elif args.t2_passes is not None:
        plane = lut_passes(plane, tables.tab2, args.t2_passes)
    plane = plane_grads(plane, pgrad[3:], pack.PGRAD_SINGLES)
    if not compose_d1:
        v1, m1 = d1_vals(args.d1_prm, args.d1_codes4, args.d1_wm2, h8, w8)
        plane = blend(plane, v1, m1)
    if args.alpha is None:
        return plane.view(torch.uint8).reshape(*lead, h8, w8, 4)[..., :3]
    a = args.alpha
    # the host's launch of the join; the card's time is in the device trace
    with profiler.stage("decode:alpha"):
        plane = plane | (alphamod.alpha_plane(a.spec, a.raw, a.mip, h8, w8)
                         .to(torch.int32) << 24)
    return plane.view(torch.uint8).reshape(*lead, h8, w8, 4)


def decode_plan(plan: plannermod.DecodePlan, tables: Tables,
                t3_d1: bool = False, grad_final: bool = False, **forms
                ) -> np.ndarray:
    """Pack, upload and decode one plan on the tables' device; [H, W, 3]
    (or [H, W, 4] with alpha) u8. `t3_d1` and `grad_final` go to
    `decode_core`, `forms` to `pack.plan_to_args`."""
    with profiler.stage("decode:pack-args"):
        args = upload(pack.plan_to_args(plan, tables.lut, tables.lut2,
                                        **forms), tables.tab.device)
    with profiler.stage("decode:device"):
        with profiler.stage("decode:dispatch"):
            out = decode_core(args, tables, t3_d1=t3_d1,
                              grad_final=grad_final)
        with profiler.stage("decode:download"):
            return to_host(out[: plan.height, : plan.width])


def decode_plnt_plane(luts: torch.Tensor, codes: torch.Tensor,
                      vmask: torch.Tensor, nty: int, ntx: int
                      ) -> torch.Tensor:
    """The pixel stage of the PLNT plane decode (`pack.plnt_args`'
    operands, as tensors on one device), the counterpart of
    `jax_engine.decode_plnt_plane_device`: each pixel's entry of its
    tile's 16-entry LUT (a gather, where the TPU takes a one-hot product),
    -999 where the mask leaves a pixel unwritten, tiles relaid to image
    order. Returns the [nty*8, ntx*8] i32 plane."""
    vals = torch.gather(luts, 1, codes.to(torch.int64))
    vals = torch.where(vmask, vals, torch.full_like(vals, -999))
    return vals.reshape(nty, ntx, 8, 8).transpose(1, 2).reshape(
        nty * 8, ntx * 8)
