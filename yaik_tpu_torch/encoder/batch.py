"""Batched, compacted and pipelined encode: the counterpart of
`yaik_tpu/encoder/batch.py`.

- `encode_batch` scores B same-size images as one batch: the 7
  gradient passes and the six 3D passes each run once over [B, 3, H, W]
  (one launch of `score48_mode` and of `values48` per 3D pass, whatever
  B is), only the first `scap` tiles with an alive pixel of each image are
  scored, and one u8 blob per batch comes back: the gradient accepts, then
  per 3D pass the accept bits and the first `dcap` accepted tiles' rows
  (`pipeline._tile3d_all_compact`). The host emits each image from it. A
  batch in which an image overflows a cap grows the caps
  (`pipeline.caps_fit`, remembered per shape in `_CAP_STATE`) and is
  scored again as a batch. (The JAX package's `_emit_batch` encodes such
  an image alone instead; on the card every 512² image of chip_smoke's
  batch overflowed the default caps, and growing them costs one more
  batch dispatch where that costs B single-image encodes.)
- `encode_corpus` groups images by shape and queues batch k+1 on the card
  before it downloads and emits batch k, as `decode_corpus` does. Caps
  grow as in `encode_batch`. (A deeper pipeline, batch k's blob copied
  into pinned memory behind an event while up to two later batches were
  queued, measured no faster on an H100 host: the host's dispatch of a
  batch outlasts the card's scoring of it, and emission takes 83-86% of
  the wall; PERF.md.)
- `encode_image_banded` scores one image in horizontal bands of 16-row
  multiples, each with a one-row halo, and emits the joined grids.
- `encode_image_banded_mesh` scores one image in one band per device
  (the JAX package's band arithmetic: equal bands of 16-row multiples,
  the bottom padded by repeating the last row, a one-row halo each).
Both score their bands with `pipeline.score_dense`, as `api.score_image`
scores a whole image, which is their one-band case.

Every stream is byte-identical to `api.encode_image`'s (and so to the JAX
package's). The JAX package's environment variables are keyword arguments
here, with its defaults: `cap_frac` and `dcap_frac` (YAIK_ENC_CAP_FRAC,
YAIK_ENC_DCAP_FRAC: caps T/8 and T/16, at least 64), `emit_workers`
(YAIK_EMIT_WORKERS, no threads) and `max_pix` (YAIK_DEVICE_SCORE_MAX_PIX,
the port's own ceiling below); YAIK_ENC_DEPTH has no counterpart (above).
YAIK_ZSTD_WORKERS has none either: each zstd batch, every emission
thread's too, goes to the process's pool of one thread per core
(`context._ZstdBatch.run`).
Short batches are not padded: the JAX package pads them to reuse one
compiled executable, and the port has none to reuse. RGBA images are
taken, as by the JAX batch engine: the card scores their RGB planes, and
the alpha chunks are host work of each image's emission. So are the
passes the reference leaves disabled, where the config turns them on,
save `enable_2d`: these entry points take no 2D bank, and raise the JAX
package's ValueError for it.

Sharding over several devices, the JAX package's `mesh=` over a "data"
axis: `encode_batch` and `encode_corpus` take `devices=`, a list of
torch devices in the mesh's place (`parallel.batch.data_devices`). Each
batch is split into `len(devices)` equal slices of its images; slice i is
uploaded and scored on `devices[i]` with that device's bank tables and
scan orders, its blob comes back by its own `.cpu()`, and its images are
emitted in order. A slice that overflows a cap is scored again with the
grown caps, which `_CAP_STATE` shares between all devices. The bytes are
those of the unsplit encode. A batch (`encode_batch`) or a `batch_size`
(`encode_corpus`) that the device count does not divide raises the JAX
package's ValueError; a short last batch of a corpus is not padded, and
its slices differ by at most one image. `device=` beside `devices=`
raises.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from yaik_tpu_torch.decoder.engine import (CARD, device_of, devices_of,
                                           to_host)
from yaik_tpu_torch.encoder import api, pipeline, scoring
from yaik_tpu_torch.encoder import bank as bankmod
from yaik_tpu_torch.encoder.context import EncoderConfig, _ZstdBatch
from yaik_tpu_torch.encoder.tables import BankTables, device_tables
from yaik_tpu_torch.format import swizzle
from yaik_tpu_torch.ops import kernels
from yaik_tpu_torch.parallel import batch as pbatch
from yaik_tpu_torch.utils import profiler

__all__ = ["encode_batch", "encode_corpus", "encode_image_banded",
           "encode_image_banded_mesh"]

# Pixels per scoring dispatch (all images of a batch, or one band). The
# scoring's transients peak at 139 bytes per pixel above the planes
# (chip_smoke.py on an NVIDIA H100 80GB HBM3: B = 16 512² and one
# 3840x2160 image alike): the claims (3 B), the tiles, k, c, a_c, b_c and
# the division's temporaries of a 3D pass (i32, 12 B each), the gradient
# passes' [.., th, tw] blends. The card's 80 GB would hold ~570 MPix of
# that; 256 MiPix keeps half of it free. A 3840x2160 image is 8.3 MPix,
# so only batches of many large images are split, and no real image is
# banded. (The JAX package's 2 MiPix is a TPU's memory limit, not this
# card's.)
DEVICE_SCORE_MAX_PIX = 256 << 20


def _grad_packed_len(w: int, h: int) -> int:
    """Byte length of the blob's gradient-accepts prefix: the packed
    accepts of `kernels.grad_score`."""
    return kernels.grad_score_len(h, w)


_upload = pipeline.upload      # the name chip_smoke.py reads


def _score_gradients(planes: torch.Tensor, cfg: EncoderConfig):
    """(the 7 gradient passes' accepts packed [B, G] u8, as
    `kernels.grad_score` writes them, the claims)."""
    claims = torch.zeros(planes.shape, dtype=torch.bool,
                         device=planes.device)
    return scoring.gradient_packed(planes, claims, cfg.reject_factor), claims


@dataclasses.dataclass
class _InFlight:
    """A queued batch: its images (and their indices), the caps, bank
    tables and scan orders it was scored with, and its blob on the device,
    where the device may still be writing it."""
    chunk: list
    imgs: list
    caps: tuple
    tables: BankTables
    perms: list
    blob: torch.Tensor

    def wait(self) -> np.ndarray:
        """The blob on the host (waits for the card)."""
        with profiler.stage("encode:drain"):
            return to_host(self.blob)


def _dispatch_batch(chunk: list, imgs: list, cfg: EncoderConfig, tables,
                    caps: tuple, perms: list) -> _InFlight:
    """Upload one batch and queue its gradient and compacted 3D scoring;
    returns before the card has finished (on the CPU, after)."""
    with profiler.stage("encode:dispatch"):
        planes = _upload(imgs, perms[0].device)
        packed_g, claims = _score_gradients(planes, cfg)
        blob = torch.cat([packed_g, pipeline._tile3d_all_compact(
            planes, claims, tables, perms, caps)], dim=1)
        return _InFlight(chunk, imgs, caps, tables, perms, blob)


def _dispatch_split(chunks: list, imgs: list, cfg: EncoderConfig,
                    states: list, caps: tuple) -> list:
    """Queue the scoring of each chunk (image indices) on its device, whose
    (bank tables, scan orders) are the matching entry of `states`: one
    `_InFlight` a chunk."""
    return pbatch.over_slices(_dispatch_batch, [
        (c, [imgs[i] for i in c], cfg, tabs, caps, perms)
        for c, (tabs, perms) in zip(chunks, states)])


def _device_states(bank: bankmod.Bank, devs: list, w: int, h: int) -> list:
    """Each device's (bank tables, scan orders of a w x h image)."""
    return [(device_tables(bank, d), pipeline.scan_perms(w, h, d))
            for d in devs]


def _emit_from_unpacked(imgs: list, packed: np.ndarray, per_pass: list,
                        cfg: EncoderConfig, emit_workers: int = 0) -> list:
    """Each image's stream from the unpacked blob of a batch that fit its
    caps. With `emit_workers` > 1 the images are emitted on that many
    threads, each with its own zstd batch (the host library's and zstd's
    calls release the GIL); else all streams go to one shared zstd batch.
    Every batch compresses on the process's zstd pool."""
    h, w = imgs[0].shape[:2]
    grad = scoring.split_accepts(packed, h, w)

    def emit(i: int, zb: _ZstdBatch):
        return api.emit_image(
            imgs[i], [a[i] for a in grad],
            [{"shift": res["shift"], "bits_scan": res["bits_scan"][i],
              "count": res["count"][i], "rows": res["rows"][i]}
             for res in per_pass], cfg, defer=zb)
    if emit_workers > 1 and len(imgs) > 1:
        here = profiler.current()

        def emit_one(i):
            with profiler.stage("emit:image", parent=here):
                zb = _ZstdBatch()
                mk = emit(i, zb)
                zb.run()
                return mk()

        with ThreadPoolExecutor(emit_workers) as pool:
            return list(pool.map(emit_one, range(len(imgs))))
    zb = _ZstdBatch()
    makers = [emit(i, zb) for i in range(len(imgs))]
    with profiler.stage("emit:zstd-flush"):
        zb.run()
    with profiler.stage("emit:assemble"):
        return [mk() for mk in makers]


# Caps learned per (height, width, reject_factor): a corpus that overflows
# the default caps teaches its caps once, and later batches and corpora in
# the process start from them.
_CAP_STATE: dict = {}


def _drain_adaptive(job: _InFlight, cfg: EncoderConfig,
                    emit_workers: int) -> list:
    """Wait for a batch and emit it; while any image overflows its caps,
    grow them to fit (`caps_fit`, remembered in _CAP_STATE) and score the
    batch again. Ends: caps only grow, and stop at T."""
    h, w = job.imgs[0].shape[:2]
    key = (h, w, cfg.reject_factor)
    G = _grad_packed_len(w, h)
    caps = job.caps
    while True:
        flat = job.wait()
        per_pass = pipeline.unpack_compact(flat[:, G:], w, h, caps)
        fit = pipeline.caps_fit(per_pass, caps, w, h)
        if fit == caps:
            return _emit_from_unpacked(job.imgs, flat[:, :G], per_pass, cfg,
                                       emit_workers)
        caps = tuple((max(s1, s2), max(d1, d2)) for (s1, d1), (s2, d2)
                     in zip(fit, _CAP_STATE.get(key, fit)))
        _CAP_STATE[key] = caps
        job = _dispatch_batch(job.chunk, job.imgs, cfg, job.tables, caps,
                              job.perms)


def _checked(images, cfg: EncoderConfig) -> list:
    """The images as arrays, checked as `encode_image` checks them; with
    no 2D bank to take, `enable_2d` raises the JAX package's ValueError."""
    imgs = [np.asarray(im) for im in images]
    for im in imgs:
        api._check(im)
    api._check_bank2d(cfg, None)
    return imgs


def _per_dispatch(h: int, w: int, batch_size: int, max_pix: int) -> int:
    """Images of h x w per dispatch: batch_size, or fewer under max_pix."""
    return max(1, min(batch_size, max_pix // (h * w)))


def _drain_split(jobs: list, cfg: EncoderConfig, emit_workers: int,
                 results: list) -> None:
    """Each queued chunk's streams into `results` at its image indices."""
    for job in jobs:
        for i, st in zip(job.chunk, _drain_adaptive(job, cfg, emit_workers)):
            results[i] = st


def _banded_each(imgs: list, idxs: list, bank: bankmod.Bank,
                 cfg: EncoderConfig, devs: list, max_pix: int,
                 results: list) -> None:
    """`encode_image_banded` of the images at `idxs`, in turn on each
    device of `devs`."""
    for k, i in enumerate(idxs):
        results[i] = encode_image_banded(imgs[i], bank, cfg,
                                         devs[k % len(devs)],
                                         max_pix=max_pix)


def encode_batch(images, bank: bankmod.Bank,
                 config: EncoderConfig | None = None, device=CARD,
                 cap_frac: int = 8, dcap_frac: int = 16,
                 emit_workers: int = 0,
                 max_pix: int = DEVICE_SCORE_MAX_PIX,
                 devices: list | None = None) -> list[bytes]:
    """Encode B same-shaped [h, w, 3|4] u8 images with batched, compacted
    device scoring on `device`, or split over `devices`; returns their
    streams. Caps start from those learned for the shape. Images of more
    than `max_pix` pixels are scored in bands (`encode_image_banded`, in
    turn on each device), and a slice of more pixels in parts."""
    cfg = config or EncoderConfig()
    imgs = _checked(images, cfg)
    if any(im.shape != imgs[0].shape for im in imgs):
        raise ValueError("encode_batch requires same-shaped images")
    devs = devices_of(device, devices)
    if len(imgs) % len(devs):
        raise ValueError(
            f"encode over {len(devs)} devices: they must divide the batch "
            f"size {len(imgs)} - pass a batch whose size is a multiple of "
            "the device count")
    h, w = imgs[0].shape[:2]
    streams: list = [None] * len(imgs)
    if h * w > max_pix:
        _banded_each(imgs, range(len(imgs)), bank, cfg, devs, max_pix,
                     streams)
        return streams
    states = _device_states(bank, devs, w, h)
    slices = pbatch.split(list(range(len(imgs))), len(devs))
    per = _per_dispatch(h, w, len(slices[0]), max_pix)
    for s in range(0, len(slices[0]), per):
        caps = _CAP_STATE.get((h, w, cfg.reject_factor), pipeline.pass_caps(
            w, h, cap_frac, dcap_frac))
        _drain_split(_dispatch_split([sl[s:s + per] for sl in slices], imgs,
                                     cfg, states, caps),
                     cfg, emit_workers, streams)
    return streams


def encode_corpus(images, bank: bankmod.Bank,
                  config: EncoderConfig | None = None, batch_size: int = 8,
                  device=CARD, emit_workers: int = 0, cap_frac: int = 8,
                  dcap_frac: int = 16,
                  max_pix: int = DEVICE_SCORE_MAX_PIX,
                  devices: list | None = None) -> list[bytes]:
    """Encode a corpus of [h, w, 3|4] u8 images of any shapes: grouped by
    shape, scored in batches of up to `batch_size` on `device`, or each
    batch split over `devices`, batch k+1 queued before batch k is
    downloaded and emitted. Caps start from those learned for the shape.
    Returns the streams in input order, byte-identical to
    `encode_image`'s."""
    cfg = config or EncoderConfig()
    if batch_size < 1:
        raise ValueError(f"batch_size {batch_size} < 1")
    devs = devices_of(device, devices)
    if batch_size % len(devs):
        raise ValueError(
            f"encode_corpus(devices=...): batch_size {batch_size} must be "
            f"a multiple of the {len(devs)} devices")
    imgs = _checked(images, cfg)
    with profiler.stage("encode:corpus"):
        results: list = [None] * len(imgs)
        groups: dict = {}
        for i, im in enumerate(imgs):
            groups.setdefault(im.shape, []).append(i)
        inflight: deque = deque()
        for shape, idxs in groups.items():
            h, w = shape[:2]
            if h * w > max_pix:
                _banded_each(imgs, idxs, bank, cfg, devs, max_pix, results)
                continue
            key = (h, w, cfg.reject_factor)
            base_caps = pipeline.pass_caps(w, h, cap_frac, dcap_frac)
            states = _device_states(bank, devs, w, h)
            per = _per_dispatch(h, w, batch_size // len(devs), max_pix)
            step = per * len(devs)
            for s in range(0, len(idxs), step):
                inflight.append(_dispatch_split(
                    pbatch.split(idxs[s:s + step], len(devs)), imgs, cfg,
                    states, _CAP_STATE.get(key, base_caps)))
                if len(inflight) > 1:
                    _drain_split(inflight.popleft(), cfg, emit_workers,
                                 results)
        while inflight:
            _drain_split(inflight.popleft(), cfg, emit_workers, results)
        return results


def _band_rows(w: int, h: int, max_pix: int = DEVICE_SCORE_MAX_PIX) -> int:
    """The largest band height, a multiple of 16 rows, whose pixels fit
    `max_pix` (at least 16, at most h). 16-row bands keep every gradient
    (<= 16 rows) and 3D (<= 8 rows) tile inside one band, and claims act
    within a tile, so each band's grids equal the full image's rows."""
    return min(max(16, (max_pix // w) & ~15), h)


def encode_image_banded(img, bank: bankmod.Bank,
                        config: EncoderConfig | None = None, device="cuda",
                        band_rows: int | None = None,
                        max_pix: int = DEVICE_SCORE_MAX_PIX) -> bytes:
    """Encode one [h, w, 3|4] u8 image scored in horizontal bands of
    `band_rows` rows (a multiple of 16; default the most that `max_pix`
    allows): each band with one pixel row below it (its tiles' bottom
    corners read that row, as the full image's scoring does), dense
    results downloaded once per band, joined into the full grids and
    emitted. A remainder under 16 rows joins the last band. Byte-identical
    to `encode_image`."""
    cfg = config or EncoderConfig()
    img = _checked([img], cfg)[0]
    h, w = img.shape[:2]
    if band_rows is not None and (band_rows < 16 or band_rows % 16):
        raise ValueError(f"band_rows {band_rows} is not a positive "
                         "multiple of 16")
    band = _band_rows(w, h, max_pix) if band_rows is None else band_rows
    tables = device_tables(bank, device_of(device))
    parts = []
    y0 = 0
    while y0 < h:
        bh = min(band, h - y0)
        if 0 < h - y0 - bh < 16:
            bh = h - y0          # a sub-16 remainder joins this band
        halo = 1 if y0 + bh < h else 0
        parts += pipeline.score_dense([(img[y0:y0 + bh + halo], tables)],
                                      cfg.reject_factor)
        y0 += bh
    return api.emit_image(img, *_join_bands(parts, w, h), cfg)


def _join_bands(parts: list, w: int, h: int) -> tuple:
    """One image's (7 accept grids, six dense 3D dicts) from its bands',
    top to bottom (`pipeline.score_dense`'s results), cut to the image's
    tile rows (the mesh pads its bottom band)."""
    accepts = [np.concatenate([p[0][k] for p in parts])[:h >> sy]
               for k, (_, sy) in enumerate(swizzle.GRADIENT_PASS_ORDER)]
    t3 = []
    for k, (sx, sy) in enumerate(swizzle.TILE3D_PASS_ORDER):
        T = (h >> sy) * (w >> sx)
        t3.append({"shift": (sx, sy)} | {
            key: np.concatenate([p[1][k][key] for p in parts])[:T]
            for key in ("idx", "mask", "accept", "type", "bbox")})
    return accepts, t3


def encode_image_banded_mesh(img, bank: bankmod.Bank,
                             config: EncoderConfig | None = None,
                             devices: list | None = None) -> bytes:
    """Encode one [h, w, 3|4] u8 image scored in one band per device of
    `devices` (default `data_devices()`, every card), the JAX package's
    `encode_image_banded_mesh`: n = len(devices) equal bands of bh =
    ceil(h / n) rounded up to 16 rows, the bottom padded to n * bh + 1
    rows by repeating the last row (the clamp the full image's scoring
    applies at its edge), each band with its one-row halo. Band i is
    scored densely on `devices[i]`; the bands' grids are joined and cut
    back to the image's tile rows and emitted. Byte-identical to
    `encode_image`. Heights that are not a multiple of 16 raise, as
    there."""
    cfg = config or EncoderConfig()
    img = _checked([img], cfg)[0]
    h, w = img.shape[:2]
    if h % 16:
        # partial bottom tile rows use ceil grid counts in emission, which
        # the floor-count band grids cannot represent
        raise ValueError("banded mesh encode requires height % 16 == 0")
    devs = (pbatch.data_devices() if devices is None
            else devices_of(CARD, devices))
    n = len(devs)
    bh = (-(-h // n) + 15) & ~15
    src = img[:, :, :3]
    padded = np.concatenate([src, np.repeat(src[-1:], n * bh + 1 - h,
                                            axis=0)])

    parts = pipeline.score_dense(
        [(padded[i * bh:(i + 1) * bh + 1], device_tables(bank, d))
         for i, d in enumerate(devs)], cfg.reject_factor)
    return api.emit_image(img, *_join_bands(parts, w, h), cfg)
