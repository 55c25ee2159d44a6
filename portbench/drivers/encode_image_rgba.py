"""One-page encode of RGBA sprite-atlas pages: `yaik_tpu_torch.encode_image`
of one page per item, each answer the finished stream.

The pages are made here, from the configuration's seed (`sheets(cfg)`):

- sprites are silhouettes, each the union of 3-6 ellipses or capsules,
  inside rectangles of `sprite_px` (64-512 px) a side;
- the rectangles are shelf-packed (tallest first, each into the first
  shelf it fits, a new shelf below when none does) with 2 px between them
  and from the page's border (TexturePacker's default shape and border
  padding), until they cover `fill` of the page or no more fit;
- RGB is `gen.images.make_main`'s mix at the page's size, zeroed wherever
  alpha is 0, as packers clean transparent pixels;
- a page with `soft` edges has a 2.5 px alpha ramp at every silhouette's
  edge (analog alpha: 8-bit ALPM under the codec's defaults); the others
  have hard edges (alpha 0 or 255: 1-bit ALPM).
"""
from __future__ import annotations

import os

import numpy as np

from portbench.drivers.encode_image import entry  # noqa: F401 (the harness calls it)

KIND = "encode"

PAD = 2           # px between rectangles and from the page's border
RAMP = 2.5        # px of a soft edge's alpha ramp


def _shelf_pack(rng, h, w, lo, hi, fill):
    """[(y, x, rh, rw)] of rectangles packed in shelves: sides drawn
    log-uniform in [lo, hi] (more small sprites than large, as in an atlas)
    until they would cover 1.25 pages, then placed tallest first, each into
    the first shelf with room or a new shelf below, until they cover
    `fill` of the page; a rectangle that finds no room is left out."""
    cand, area = [], 0
    while area < 1.25 * h * w:
        rh, rw = (int(v) for v in np.exp(rng.uniform(np.log(lo),
                                                     np.log(hi + 1), 2)))
        cand.append((rh, rw))
        area += rh * rw
    cand.sort(key=lambda r: -r[0])
    shelves = []              # [y, height, x of the next free column]
    placed, area = [], 0
    for rh, rw in cand:
        if area >= fill * h * w:
            break
        for s in shelves:
            if rh <= s[1] and s[2] + rw + PAD <= w:
                placed.append((s[0], s[2], rh, rw))
                s[2] += rw + PAD
                break
        else:
            y = shelves[-1][0] + shelves[-1][1] + PAD if shelves else PAD
            if y + rh + PAD > h or PAD + rw + PAD > w:
                continue
            shelves.append([y, rh, PAD + rw + PAD])
            placed.append((y, PAD, rh, rw))
        area += rh * rw
    return placed


def _silhouette_sdf(rng, rh, rw):
    """Distance (px, negative inside) to a union of 3-6 rotated ellipses
    or capsules, each scaled to lie, ramp and all, inside an rh x rw
    rectangle."""
    yy, xx = np.mgrid[0:rh, 0:rw].astype(np.float64)
    d = np.full((rh, rw), np.inf)
    for k in range(int(rng.integers(3, 7))):
        if k == 0:                            # the body, at the middle
            cy, cx, lo, hi = rh / 2, rw / 2, 0.42, 0.5
        else:                                 # limbs, ears, props
            cy, cx = rng.uniform(0.15, 0.85, 2) * (rh, rw)
            lo, hi = 0.18, 0.38
        a, b = rng.uniform(lo, hi, 2) * (rw, rh)
        t = rng.uniform(0, np.pi)
        c, s = np.cos(t), np.sin(t)
        room_y = min(cy, rh - cy) - RAMP - 1
        room_x = min(cx, rw - cx) - RAMP - 1
        if rng.random() < 0.5:                # ellipse, semi-axes a, b
            k_ = min(1.0, room_x / np.hypot(a * c, b * s),
                     room_y / np.hypot(a * s, b * c))
            a, b = a * k_, b * k_
            if min(a, b) < 2:
                continue
            u = (xx - cx) * c + (yy - cy) * s
            v = (yy - cy) * c - (xx - cx) * s
            d = np.minimum(d, (np.hypot(u / a, v / b) - 1) * min(a, b))
        else:                                 # capsule: a segment, radius r
            r = min(a, b) * rng.uniform(0.4, 0.8)
            ln = max(a, b) - r
            k_ = min(1.0, room_x / (abs(ln * c) + r),
                     room_y / (abs(ln * s) + r))
            r, ln = r * k_, ln * k_
            if r < 2:
                continue
            py, px = yy - (cy - ln * s), xx - (cx - ln * c)
            q = np.clip((py * s + px * c) / (2 * ln), 0, 1) if ln > 0 else 0
            d = np.minimum(d, np.hypot(py - q * 2 * ln * s,
                                       px - q * 2 * ln * c) - r)
    return d


def page(seed: int, h: int, w: int, soft: bool, sprite_px=(64, 512),
         fill: float = 0.9) -> np.ndarray:
    """One [h, w, 4] u8 atlas page from `seed`."""
    from portbench.gen import images
    rgb = images.make_main(np.random.default_rng(seed), h, w)
    rng = np.random.default_rng([seed, 4])     # the layout's own stream
    alpha = np.zeros((h, w))
    for y, x, rh, rw in _shelf_pack(rng, h, w, *sprite_px, fill):
        d = _silhouette_sdf(rng, rh, rw)
        a = np.clip(0.5 - d / RAMP, 0, 1) if soft else (d <= 0) * 1.0
        alpha[y:y + rh, x:x + rw] = a
    alpha = np.round(alpha * 255).astype(np.uint8)
    return np.dstack([np.where(alpha[:, :, None] > 0, rgb, 0), alpha])


def transparent_tile_share(rgba: np.ndarray, ts: int = 16) -> float:
    """The share of the page's ts x ts tiles whose alpha is all 0."""
    h, w = rgba.shape[:2]
    t = rgba[:h // ts * ts, :w // ts * ts, 3].reshape(h // ts, ts,
                                                      w // ts, ts)
    return float((t.max(axis=(1, 3)) == 0).mean())


def sheets(cfg: dict) -> list:
    """The configuration's pages, in pool order: page i from `seeds[i]`,
    with soft edges where `soft_edges[i]`. The file counts its pages four
    times (`sheets`, `images.bases` x `images.variants`, the seeds, the
    edge flags); they must agree, or pages would meet the wrong streams."""
    spec = cfg["images"]
    n = len(spec["seeds"])
    if not n == cfg["sheets"] == spec["bases"] * spec["variants"] == \
            len(spec["soft_edges"]):
        raise ValueError("the configuration's page counts disagree")
    return [page(spec["seeds"][i], cfg["height"], cfg["width"],
                 spec["soft_edges"][i], tuple(spec["sprite_px"]),
                 spec["fill"])
            for i in range(n)]


def inputs(cell):
    """The pages, the committed streams the plain encoder made of them,
    the 3D bank and the encoder settings."""
    from portbench.harness import loop
    from yaik_tpu_torch.encoder import bank, context
    cfg = cell.config
    pool = os.path.join(cell.root, cfg["pool"])
    streams = []
    for n in sorted(n for n in os.listdir(pool) if n.endswith(".yaik")):
        with open(os.path.join(pool, n), "rb") as f:
            streams.append(f.read())
    imgs = sheets(cfg)
    if len(streams) != len(imgs):
        raise ValueError(f"{len(streams)} committed streams for "
                         f"{len(imgs)} pages")
    inp = loop.Inputs(n=len(imgs), images=imgs,
                      pixels=[im.shape[0] * im.shape[1] for im in imgs])
    inp.bank3d = bank.load_bank(os.path.join(cell.root, cfg["bank3d"]))
    inp.encoder_config = context.EncoderConfig(**cfg["encoder"])
    return inp, streams

