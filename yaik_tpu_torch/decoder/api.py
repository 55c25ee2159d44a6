"""Public decode API of the port.

`decode_image(stream, lut, device="cuda")` decodes one `.yaik` stream on
`device` ("cuda", the default, for the hand kernels, "cpu" for their plain
versions): every stream the JAX engine decodes, RGB or RGBA, with
all-plane and plane-variant GTIL, 3DTL/3DTX, 2DTL, UCOL/SMAP and 1DTL
chunks (PLNT chunks are validated and skipped, as by every decoder of the
codec).
`lut` is a `LutBank` (from `assign_lut(lut, lut2d)`; a stream with 2DTL
tiles needs the 2D LUT), or any object with the same `expanded` and
`expanded2d` dicts (the JAX package's `LutBank`), or the raw bytes of a
LutFile. A stream the port cannot decode raises; it is never handed to the
host decoder behind the caller's back.

`t3_d1` and `grad_final` choose the fused forms of the standard decode
(see `engine.decode_core`); both are off by default, as in the JAX
package (`YAIK_T3_D1`, `YAIK_GRAD_FINAL`).

`engine="host"` decodes with the numpy reference decoder
(`decoder/reference.py`, the JAX package's default engine) instead: no
tensor, no kernel, and `device`, `t3_d1` and `grad_final` play no part.
The device engine stays the default; the host one runs only when named.
"""
from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from yaik_tpu_torch.decoder import engine as enginemod
from yaik_tpu_torch.decoder.engine import device_of
from yaik_tpu_torch.decoder import planner as plannermod
from yaik_tpu_torch.decoder import reference
from yaik_tpu_torch.format import lut as lutmod
from yaik_tpu_torch.format.headers import MAGIC, FileHeader
from yaik_tpu_torch.utils import profiler

__all__ = ["LutBank", "assign_lut", "decode_image", "decode_image_pre",
           "DeviceTables"]


@dataclass(eq=False)
class LutBank:
    """A parsed and expanded LUT bank (the port's copy of
    `yaik_tpu.decoder.api.LutBank`): `expanded` bit -> [n*64, 2^bit, 3] i32
    3D tables, `expanded2d` bit -> [n*8, 2^bit, 2] i32 2D tables or None."""
    tables: dict
    expanded: dict
    tables2d: dict | None = None
    expanded2d: dict | None = None


def assign_lut(lut_data: bytes, lut2d_data: bytes | None = None) -> LutBank:
    """Parse and expand a LutFile.lut ('LUL0'), and a LutFile2D.lut
    ('LU20') for streams with 2DTL tiles."""
    tables = lutmod.parse_lut_file(lut_data)
    bank = LutBank(tables, lutmod.expand_lut(tables))
    if lut2d_data is not None:
        bank.tables2d = lutmod.parse_lut2d_file(lut2d_data)
        bank.expanded2d = lutmod.expand_lut2d(bank.tables2d)
    return bank


def decode_image_pre(stream: bytes):
    """(width, height, has_alpha) from the file header alone, like
    YAIK_DecodeImagePre (the port's copy of
    `yaik_tpu.decoder.api.decode_image_pre`)."""
    fh = FileHeader.unpack(stream)
    if fh.tag != MAGIC:
        raise ValueError("not a YAIK stream")
    return fh.width, fh.height, fh.has_alpha


def bank_of(lut) -> LutBank:
    """A bank from what `decode_image` takes: a `LutBank` (or an object
    with its `expanded` and `expanded2d`), or the raw bytes of a
    LutFile."""
    if isinstance(lut, (bytes, bytearray)):
        return assign_lut(bytes(lut))
    return lut


class DeviceTables:
    """`build(bank, device)` results, kept per (bank, device). Banks are
    held weakly, so an entry lives as long as its bank. Threads may share
    it: an entry is built once, under a lock."""

    def __init__(self, build):
        self._build = build
        self._entries: list = []     # (weakref to bank, device, value)
        self._lock = threading.Lock()

    def get(self, bank, device: torch.device):
        with self._lock:
            self._entries = [e for e in self._entries
                             if e[0]() is not None]
            for ref, dev, value in self._entries:
                if ref() is bank and dev == device:
                    return value
            value = self._build(bank, device)
            self._entries.append((weakref.ref(bank), device, value))
            return value


_TABLES = DeviceTables(lambda bank, dev: enginemod.Tables.build(
    bank.expanded, bank.expanded2d, dev))


def decode_image(stream: bytes, lut: LutBank | bytes, device="cuda",
                 t3_d1: bool = False, grad_final: bool = False,
                 engine: str = "device") -> np.ndarray:
    """Decode a stream on `device` (the card unless the caller asks for
    "cpu"), or on the host with `engine="host"`; returns [H, W, 3] u8, or
    [H, W, 4] for a stream with alpha."""
    lut = bank_of(lut)
    if engine == "host":
        return reference.decode(stream, lut.expanded, lut.expanded2d)
    if engine != "device":
        raise ValueError(f"unknown engine {engine!r}")
    with profiler.stage("decode:image"):
        dev = device_of(device)
        tables = _TABLES.get(lut, dev)
        with profiler.stage("decode:plan"):
            plan = plannermod.build_plan(stream, lut.expanded,
                                         lut.expanded2d)
        return enginemod.decode_plan(plan, tables, t3_d1=t3_d1,
                                     grad_final=grad_final)
