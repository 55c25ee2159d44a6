"""LUT-bank mining: build Bank3D point clouds (and Bank2D pattern PNGs) from
a training corpus. The counterpart of `yaik_tpu/encoder/mining.py`'s device
engine.

The reference's research workflow (SURVEY section 3.4): capture mode dumps
each unclaimed full tile's normalized RGB cloud (Correlation3DSearch,
EncoderContext.cpp:6350-6433), then evaluateLUT mode re-runs the encoder per
candidate to measure coverage (:8904-8985). In-process here, as in the JAX
package:

  capture_clouds: normalized 64-point clouds of gradient-unclaimed 8x8
    tiles, the claims from the device's gradient scoring
    (`scoring.gradient_all`, the JAX device engine's
    `jax_scoring.gradient_all_device`)
  evaluate_candidates: greedy coverage selection over the [k, n] coverage
    matrix, computed on the device by `kernels.covers` (the hand kernel of
    csrc/covers.cu; its plain version for device="cpu")
  mine_bank: corpus -> Bank3D files loadable by both encoders
  capture_clouds_2d / mine_bank2d: the same for Bank2D pattern PNGs, the
    capture on the host gradient scorer (as in the JAX package), the
    coverage matrix by `kernels.covers2d`

The JAX package's `engine="host"|"device"` is `device="cuda"` (the
default) or `"cpu"` here; every output file equals the JAX package's
`engine="device"` one byte for byte.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from yaik_tpu_torch.decoder.engine import device_of
from yaik_tpu_torch.encoder import bank as bankmod
from yaik_tpu_torch.encoder import gradient, scoring
from yaik_tpu_torch.encoder.corr2d import PAIR
from yaik_tpu_torch.format import swizzle
from yaik_tpu_torch.ops import kernels


def capture_clouds(rgb: np.ndarray, reject_factor: int = 3, device="cuda"):
    """Run the gradient passes on `device`, then capture normalized clouds
    of the leftover full 8x8 tiles (the reference captures pixelsInTile >=
    64). Returns a list of [64, 3] u8 clouds."""
    h, w = rgb.shape[:2]
    planes = rgb[:, :, :3].transpose(2, 0, 1).astype(np.int32)
    dev = device_of(device)
    claims_d = torch.zeros((3, h, w), dtype=torch.bool, device=dev)
    scoring.gradient_all(torch.from_numpy(planes).to(dev), claims_d,
                         reject_factor)
    claims = claims_d.cpu().numpy()

    clouds = []
    for y in range(0, h, 8):
        for x in range(0, w, 8):
            if claims[:, y:y + 8, x:x + 8].any():
                continue
            tile = planes[:, y:y + 8, x:x + 8].reshape(3, -1).T  # [64,3]
            mn, mx = tile.min(0), tile.max(0)
            d = mx - mn
            if (d == 0).sum() >= 2:
                continue
            nvec = np.where(d > 0, (1 << 20) // np.maximum(d, 1), 0)
            r = (tile - mn) * nvec
            fr = r.astype(np.float32) / np.float32(1 << 20)
            c = (fr * np.float32(63)).astype(np.uint8)
            clouds.append(c)
    return clouds


def _greedy(cover: np.ndarray, cands: list, max_tables: int) -> list:
    """Greedy max-coverage: repeatedly the candidate that newly covers the
    most tiles (the first such on ties), until none adds one."""
    covered = np.zeros(cover.shape[1], bool)
    picked = []
    for _ in range(max_tables):
        gains = (cover & ~covered[None, :]).sum(axis=1)
        best = int(gains.argmax())
        if gains[best] == 0:
            break
        picked.append(cands[best])
        covered |= cover[best]
    return picked


def evaluate_candidates(clouds, max_tables=12, gate_px=75,
                        max_candidates=256, device="cuda"):
    """Greedy max-coverage selection of candidate clouds; the coverage
    matrix on `device` (`kernels.covers`)."""
    if not clouds:
        return []
    dev = device_of(device)
    tiles = np.stack(clouds)                       # [n, 64, 3]
    # candidates = a subsample of the captures themselves
    step = max(1, len(clouds) // max_candidates)
    cands = [bankmod.sort_palette_morton(clouds[i])
             for i in range(0, len(clouds), step)]
    cover = kernels.covers(torch.from_numpy(np.stack(cands)).to(dev),
                           torch.from_numpy(tiles).to(dev),
                           gate_px).cpu().numpy()  # [k, n]
    return _greedy(cover, cands, max_tables)


def mine_bank(images, out_dir, max_tables=12, checkpoint=None,
              device="cuda", max_candidates=256):
    """images: list of [h,w,3+] u8 arrays. Writes Bank3D-format files named
    like the reference's hardcoded list so both encoders can load them.

    checkpoint: optional .npz path - the capture phase (the long part of a
    corpus-scale mining job) saves progress after every image and resumes
    where it left off."""
    clouds = []
    start = 0
    if checkpoint and os.path.exists(checkpoint):
        saved = np.load(checkpoint)
        start = int(saved["done"])
        clouds = [saved[f"c{i}"] for i in range(int(saved["count"]))]
    for k in range(start, len(images)):
        clouds.extend(capture_clouds(np.asarray(images[k]), device=device))
        if checkpoint:
            np.savez(checkpoint + ".tmp.npz", done=k + 1, count=len(clouds),
                     **{f"c{i}": c for i, c in enumerate(clouds)})
            os.replace(checkpoint + ".tmp.npz", checkpoint)
    picked = evaluate_candidates(clouds, max_tables=max_tables,
                                 max_candidates=max_candidates,
                                 device=device)
    os.makedirs(out_dir, exist_ok=True)
    for name, cloud in zip(bankmod.BANK_FILE_NAMES, picked):
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(bytes([len(cloud) & 0xFF]))
            f.write(cloud[:, 0].tobytes())
            f.write(cloud[:, 1].tobytes())
            f.write(cloud[:, 2].tobytes())
    return len(picked), len(clouds)


# ---------------------------------------------------------------------------
# 2D bank mining: the reference's isCaptureMode2D workflow
# (Correlation2DSearch, EncoderContext.cpp:6965-6982: tiles with
# pixelsInTile >= 32 dump their normalized (a, b) samples as 64x64 PNG
# point maps into tile2DImg/ - exactly the Bank2D input format).
# ---------------------------------------------------------------------------

def capture_clouds_2d(rgb: np.ndarray, reject_factor: int = 3):
    """Capture normalized pair-channel clouds of 8x8 tiles left unclaimed by
    the gradient passes (the host scorer), per plane mode (RG/GB/RB).
    Returns a list of [n <= 64, 2] u8 point sets (deduplicated, like the
    PNG round trip)."""
    h, w = rgb.shape[:2]
    planes = rgb[:, :, :3].transpose(2, 0, 1).astype(np.int32)
    claims = np.zeros((3, h, w), bool)
    mapped = np.zeros((3, h + 1, w + 1), bool)
    for (sx, sy) in swizzle.GRADIENT_PASS_ORDER:
        gradient.run_pass(planes, claims, mapped, sx, sy, reject_factor, 250)

    clouds = []
    for mode in (0, 1, 2):
        pa, pb = PAIR[mode]
        for y in range(0, h, 8):
            for x in range(0, w, 8):
                if (claims[pa, y:y + 8, x:x + 8]
                        | claims[pb, y:y + 8, x:x + 8]).any():
                    continue
                a = planes[pa, y:y + 8, x:x + 8].reshape(-1)
                b = planes[pb, y:y + 8, x:x + 8].reshape(-1)
                mna, mxa = int(a.min()), int(a.max())
                mnb, mxb = int(b.min()), int(b.max())
                if mxa == mna or mxb == mnb:
                    continue
                na = (1 << 20) // (mxa - mna)
                nb = (1 << 20) // (mxb - mnb)
                fa = ((a - mna) * na).astype(np.float32) / np.float32(1 << 20)
                fb = ((b - mnb) * nb).astype(np.float32) / np.float32(1 << 20)
                ia = (fa * np.float32(63)).astype(np.uint8)
                ib = (fb * np.float32(63)).astype(np.uint8)
                pts = np.unique(np.stack([ia, ib], 1), axis=0)
                clouds.append(pts[:64])
    return clouds


def _padded(sets: list) -> tuple:
    """Point sets of <= 64 points -> ([m, 64, 2] i32 with pad points at
    (4096, 4096), [m, 64] bool of the real points)."""
    arr = np.full((len(sets), 64, 2), kernels.COVERS_PAD, np.int32)
    msk = np.zeros((len(sets), 64), bool)
    for i, ps in enumerate(sets):
        arr[i, :len(ps)] = ps
        msk[i, :len(ps)] = True
    return arr, msk


def mine_bank2d(images, out_dir, max_tables=12, max_candidates=256,
                device="cuda"):
    """images -> Bank2D pattern PNGs loadable by encoder.bank2d (and by the
    reference's Load2DPattern). Greedy max-coverage like the 3D miner, the
    coverage matrix on `device` (`kernels.covers2d`)."""
    from PIL import Image as _Image
    clouds = []
    for im in images:
        clouds.extend(capture_clouds_2d(np.asarray(im)))
    if not clouds:
        return 0, 0
    dev = device_of(device)
    step = max(1, len(clouds) // max_candidates)
    cands = [clouds[i] for i in range(0, len(clouds), step)]
    ops = (*_padded(cands), *_padded(clouds))
    cover = kernels.covers2d(*(torch.from_numpy(a).to(dev) for a in ops)
                             ).cpu().numpy()
    picked = _greedy(cover, cands, max_tables)
    os.makedirs(out_dir, exist_ok=True)
    for k, pts in enumerate(picked):
        img = np.zeros((64, 64, 3), np.uint8)
        img[pts[:, 1], pts[:, 0]] = 255
        _Image.fromarray(img).save(
            os.path.join(out_dir, f"t{k + 1}_tileMap{2000 + k}.lut.png"))
    return len(picked), len(clouds)
