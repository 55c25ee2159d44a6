"""The RGBA inputs that the alpha tests of the plain reference and of the
port share: the eight RGBA fixtures of `tests/fixtures/`, and the five
64x64 alpha cases with the encoder settings of each (a copy of the port's
`tests/torch_streams.py` `ALPHA_CASES` / `rgba_case`, so that nothing here
imports the port or the JAX package), and the digests the reference is held
to.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

FIX = os.path.join(ROOT, "tests", "fixtures")
RGBA = ["alpha64_1bit", "alpha64_6bit", "alpha64_8bit", "alpha64_const255",
        "alpha64_sparse", "sprite256", "sprite256_6bit", "bench_rgba512"]

ALPHA_CASES = {
    "8bit": (dict(),
             lambda yy, xx, r: r.integers(0, 256, (64, 64), np.uint8)),
    "6bit": (dict(alpha_force_8bit=False, enable_mipmap=False),
             lambda yy, xx, r: ((yy * 4 + xx) % 256).astype(np.uint8)),
    "1bit": (dict(),
             lambda yy, xx, r: np.where((yy // 8 + xx // 8) % 2 == 0,
                                        255, 0).astype(np.uint8)),
    "sparse": (dict(alpha_force_8bit=False),
               lambda yy, xx, r: np.where((yy >= 16) & (xx >= 16),
                                          (yy * 4) % 256, 0
                                          ).astype(np.uint8)),
    "const255": (dict(),
                 lambda yy, xx, r: np.full((64, 64), 255, np.uint8)),
}
CASES = sorted(ALPHA_CASES)

# The JAX package's host decode of each fixture and host encode of each
# alpha case, as digests (`jax_alpha_digests.json`, which says how they
# were made).
JAX_DIGESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "jax_alpha_digests.json")


def rgba_case(name: str) -> np.ndarray:
    """The [64, 64, 4] u8 image of alpha case `name` (seeded by its place
    in sorted order, so every run builds the same image)."""
    rng = np.random.default_rng(CASES.index(name))
    img = np.zeros((64, 64, 4), np.uint8)
    yy, xx = np.mgrid[0:64, 0:64]
    img[:, :, 0] = (yy * 3) & 0xFF
    img[:, :, 1] = (xx * 3) & 0xFF
    img[:, :, 2] = ((yy + xx) * 2) & 0xFF
    img[:, :, 3] = ALPHA_CASES[name][1](yy, xx, rng)
    return img


def read_fixture(name: str) -> bytes:
    for fn in (name + ".rgba.yaik", name + ".yaik"):
        if os.path.exists(os.path.join(FIX, fn)):
            with open(os.path.join(FIX, fn), "rb") as f:
                return f.read()
    raise FileNotFoundError(name)


def read_lut() -> bytes:
    with open(os.path.join(ROOT, "portbench", "data", "LutFile.lut"),
              "rb") as f:
        return f.read()


def reference_bank():
    from portbench.reference import bank
    return bank.load_bank(os.path.join(ROOT, "portbench", "data", "Bank3D"))


def pixels_digest(px) -> str:
    px = np.ascontiguousarray(px)
    return hashlib.sha256(repr(px.shape).encode() + px.tobytes()).hexdigest()


def form_digest(form) -> str:
    """Of a canonical form (`reference.canonical.canonical`)."""
    return hashlib.sha256(repr(form).encode()).hexdigest()


def jax_digests() -> dict:
    with open(JAX_DIGESTS) as f:
        return json.load(f)
