"""The benchmark's image generator: a frozen copy of `tools/gen_images.py`'s
`make_main` (the synthetic anime-art mix: a bilinear quilt, a colour ramp,
cel shading with speckle, and a quilt blended with a ramp, one per
quadrant), taken to h != w, and of `bench.py`'s `_enc_variant` rolls and
flips (multiples of 8 pixels, so tiles stay aligned).

`config_images(cfg)` makes a configuration's image set: `bases` images from
seeds `seed`, `seed + 1`, ..., each followed by `variants - 1` rolled or
flipped copies. The set is fixed by the configuration, never by a run's
seed: the streams the plain encoder made of it are committed beside it.
"""
from __future__ import annotations

import numpy as np


def bilinear_patch(h, w, c00, c01, c10, c11):
    ty = np.linspace(0, 1, h)[:, None, None]
    tx = np.linspace(0, 1, w)[None, :, None]
    c00, c01, c10, c11 = (np.asarray(c, np.float64)
                          for c in (c00, c01, c10, c11))
    top = c00 * (1 - tx) + c01 * tx
    bot = c10 * (1 - tx) + c11 * tx
    return top * (1 - ty) + bot * ty


def gradient_quilt(rng, h, w, cell):
    """A grid of bilinear patches with shared corner colours."""
    gh, gw = h // cell + 1, w // cell + 1
    corners = rng.integers(0, 256, (gh, gw, 3)).astype(np.float64)
    img = np.zeros((h, w, 3))
    for gy in range(h // cell):
        for gx in range(w // cell):
            img[gy * cell:(gy + 1) * cell, gx * cell:(gx + 1) * cell] = \
                bilinear_patch(cell, cell, corners[gy, gx],
                               corners[gy, gx + 1], corners[gy + 1, gx],
                               corners[gy + 1, gx + 1])
    return img


def ramp_region(rng, h, w):
    """Colours along a bent path in RGB space, spatially smooth."""
    p0 = rng.integers(0, 100, 3).astype(np.float64)
    p1 = rng.integers(100, 200, 3).astype(np.float64)
    p2 = rng.integers(180, 256, 3).astype(np.float64)
    yy, xx = np.mgrid[0:h, 0:w]
    t = (np.sin(xx / w * 2.3 + yy / h * 1.7) + 1) / 2
    t = t[:, :, None]
    return (1 - t) ** 2 * p0 + 2 * (1 - t) * t * p1 + t ** 2 * p2


def cel_region(rng, h, w, levels=4):
    """Quantized radial shading with outline-like speckle."""
    yy, xx = np.mgrid[0:h, 0:w]
    cx, cy = w * 0.6, h * 0.4
    r = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2) / (0.7 * max(h, w))
    q = np.floor(np.clip(1 - r, 0, 0.999) * levels) / levels
    base = rng.integers(60, 220, 3).astype(np.float64)
    img = base[None, None, :] * (0.4 + 0.6 * q[:, :, None])
    speck = rng.random((h, w)) < 0.02
    img[speck] = rng.integers(0, 256, (speck.sum(), 3))
    return img


def make_main(rng, h, w):
    """`tools/gen_images.py`'s make_main(rng, size) at h = w = size, and
    the same quadrants at any h, w."""
    img = np.zeros((h, w, 3))
    img[: h // 2, : w // 2] = gradient_quilt(rng, h // 2, w // 2, 32)
    img[: h // 2, w // 2:] = ramp_region(rng, h // 2, w - w // 2)
    img[h // 2:, : w // 2] = cel_region(rng, h - h // 2, w // 2)
    q = gradient_quilt(rng, h - h // 2, w - w // 2, 64)
    r = ramp_region(rng, h - h // 2, w - w // 2)
    img[h // 2:, w // 2:] = 0.5 * q + 0.5 * r
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def variant(img, i):
    """`bench.py`'s `_enc_variant`: rolls by multiples of 8 pixels, and a
    vertical or horizontal flip for i % 3 == 1 or 2."""
    v = np.roll(img, 8 * ((i * 7) % 63 + 1), axis=1)
    v = np.roll(v, 8 * ((i * 5) % 63 + 1), axis=0)
    if i % 3 == 1:
        v = v[::-1]
    elif i % 3 == 2:
        v = v[:, ::-1]
    return np.ascontiguousarray(v)


def config_images(cfg: dict) -> list:
    """The configuration's images, [h, w, 3] u8, in pool order: each base
    then its variants 1 .. variants - 1."""
    spec = cfg["images"]
    h, w = cfg["height"], cfg["width"]
    out = []
    for b in range(spec["bases"]):
        base = make_main(np.random.default_rng(spec["seed"] + b), h, w)
        out.append(base)
        out += [variant(base, v) for v in range(1, spec["variants"])]
    return out
