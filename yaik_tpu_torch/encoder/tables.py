"""The 3D LUT bank as the scoring kernels take it.

`bank_tables` is `yaik_tpu.encoder.device_pipeline.bank_device_tables` in
numpy, on a bank from `encoder/bank.py`: each LUT's 8 scoring points in each of the 48 patterns' frames
(`transformed_points`, after `jax_scoring.transformed_points`), its 64
points and its factor tables for bits 3, 4, 5, 6. `device_tables` keeps
them on a device, once per (bank, device).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from yaik_tpu_torch.decoder.api import DeviceTables
from yaik_tpu_torch.decoder.engine import to_card
from yaik_tpu_torch.encoder import bank as bankmod
from yaik_tpu_torch.encoder.corr3d import PERMS48


class BankTables(NamedTuple):
    qpts: np.ndarray | torch.Tensor     # [E, 48, 8, 3] i32
    pts: np.ndarray | torch.Tensor      # [E, 64, 3] i32
    factors: np.ndarray | torch.Tensor  # [4, E, 64, 3] i32, bits 3..6


def transformed_points(points3bit: np.ndarray) -> np.ndarray:
    """[E, 8, 3] scoring points -> [E, 48, 8, 3] i32 Q with
    dist_field_e[T_n(c)] == min_k |c - Q[e, n, k]|^2, where pattern n maps
    c to flip_n(perm_n(c)): |flip_i(c[p[i]]) - pt[i]| = |c[p[i]] -
    flip_i(pt[i])|, so Q[p[i]] = flip_i(pt[i])."""
    pts = points3bit.astype(np.int32)
    q = np.zeros((pts.shape[0], 48, 8, 3), np.int32)
    for n in range(48):
        p = PERMS48[n]
        for i in range(3):
            v = pts[:, :, i]
            q[:, n, :, p[i]] = 63 - v if n & (1 << i) else v
    return q


def bank_tables(bank: bankmod.Bank) -> BankTables:
    """The bank as numpy i32 tables (zero-padded to 64 points)."""
    E = bank.count
    pts = np.zeros((E, 64, 3), np.int32)
    for e, p in enumerate(bank.points):
        pts[e, :len(p)] = p
    factors = np.zeros((4, E, 64, 3), np.int32)
    for e, ctx in enumerate(bank.ctxs):
        for bi, bit in enumerate((3, 4, 5, 6)):
            t = ctx.factors[bit]
            factors[bi, e, :t.shape[0]] = t
    return BankTables(transformed_points(pts[:, ::8][:, :8]), pts, factors)


_TABLES = DeviceTables(lambda bank, device: BankTables(
    *(to_card(a, device) for a in bank_tables(bank))))


def device_tables(bank: bankmod.Bank, device: torch.device) -> BankTables:
    """`bank_tables(bank)` as tensors on `device`, built once per pair."""
    return _TABLES.get(bank, device)
