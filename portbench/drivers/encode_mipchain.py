"""One-level encode of RGBA game textures with their full mip chains:
`yaik_tpu_torch.encode_image` of one mip level per item, each answer the
finished stream.

The textures are made here, from the configuration's seeds
(`textures(cfg)`): each is `encode_image_rgba.page` at the top level's
size, with the configuration's sprite sizes and fill (UV-island-like
silhouettes, RGB zeroed where alpha is 0). Each level below the top is the
rounded mean `(a + b + c + d + 2) >> 2` of the 2x2 block above it, in every
channel (a box filter, Unity's default mip filter), so RGB stays 0 wherever
alpha is 0 at every level. The chain runs down to the smallest side the
configuration lists, 8 px: the format takes sides that are multiples of 8.

The items are every level of every texture, texture-major and the top level
first, the order of the committed pool's `TT-LL.yaik` names.
"""
from __future__ import annotations

import os

import numpy as np

from portbench.drivers.encode_image import entry  # noqa: F401 (the harness calls it)
from portbench.drivers.encode_image_rgba import page

KIND = "encode"


def mip_down(img: np.ndarray) -> np.ndarray:
    """The next level of an [h, w, c] u8 image: the rounded mean of each
    2x2 block, in every channel."""
    a = img.astype(np.uint16)
    s = a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2]
    return ((s + 2) >> 2).astype(np.uint8)


def chain(top: np.ndarray, levels: list) -> list:
    """The levels of `top` whose sides are `levels` (the top's first, each
    the next smaller power of two)."""
    out = [top]
    for side in levels[1:]:
        if side * 2 != out[-1].shape[0]:
            raise ValueError(f"level {side} does not halve "
                             f"{out[-1].shape[0]}")
        out.append(mip_down(out[-1]))
    return out


def textures(cfg: dict) -> list:
    """The configuration's top levels, in pool order: texture i from
    `seeds[i]`, with soft edges where `soft_edges[i]`. The file counts its
    textures four times (`textures`, `images.bases`, the seeds, the edge
    flags) and its levels twice (`levels`, `images.variants`); they must
    agree, or levels would meet the wrong streams."""
    spec = cfg["images"]
    n = len(spec["seeds"])
    if not n == cfg["textures"] == spec["bases"] == len(spec["soft_edges"]) \
            or spec["variants"] != len(cfg["levels"]):
        raise ValueError("the configuration's texture counts disagree")
    if cfg["levels"][0] != cfg["height"] or cfg["height"] != cfg["width"]:
        raise ValueError("the chain starts at the square top level")
    return [page(spec["seeds"][i], cfg["height"], cfg["width"],
                 spec["soft_edges"][i], tuple(spec["sprite_px"]),
                 spec["fill"])
            for i in range(n)]


def inputs(cell):
    """The levels, the committed streams the plain encoder made of them,
    the 3D bank and the encoder settings."""
    from portbench.harness import loop
    from yaik_tpu_torch.encoder import bank, context
    cfg = cell.config
    pool = os.path.join(cell.root, cfg["pool"])
    streams = []
    for n in sorted(n for n in os.listdir(pool) if n.endswith(".yaik")):
        with open(os.path.join(pool, n), "rb") as f:
            streams.append(f.read())
    imgs = [lv for tex in textures(cfg) for lv in chain(tex, cfg["levels"])]
    if len(streams) != len(imgs):
        raise ValueError(f"{len(streams)} committed streams for "
                         f"{len(imgs)} levels")
    inp = loop.Inputs(n=len(imgs), images=imgs,
                      pixels=[im.shape[0] * im.shape[1] for im in imgs])
    inp.bank3d = bank.load_bank(os.path.join(cell.root, cfg["bank3d"]))
    inp.encoder_config = context.EncoderConfig(**cfg["encoder"])
    return inp, streams
