"""Make the `sprite2048` configuration's committed stream pool with the
plain encoder.

    python3 portbench/gen/make_sprite_pool.py [sprite2048] [--workers 4]

Encodes every page of the configuration (`drivers/encode_image_rgba.py`
`sheets`) with the frozen pure-Python host encoder (`reference.encoder`,
~6 min a 2048x2048 RGBA page on one core), on `workers` processes, and
writes `<pool>/NNN.yaik` and `<pool>/PROVENANCE.json`. Checks that every
stream holds MIPM and then ALPM, and that the pages with soft edges write
8-bit ALPM and the others 1-bit ALPM. Runs on the CPU; imports nothing of
the port.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing
import os
import platform
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from portbench.gen.make_pool import load_config  # noqa: E402
from portbench.harness import loop  # noqa: E402
from portbench.reference import bank, context, decoder  # noqa: E402
from portbench.reference import encoder, zstd  # noqa: E402
from portbench.reference.headers import AlphaHeader  # noqa: E402

DRIVER = "encode_image_rgba"
MODES = {AlphaHeader.IS_8_BIT_FULL: "8-bit", AlphaHeader.IS_1_BIT_FULL:
         "1-bit"}


def alpha_modes(stream: bytes) -> tuple:
    """(the stream's first two chunk tags, its ALPM mode or None)."""
    chunks = list(decoder.iter_chunks(stream))
    mode = next((AlphaHeader.unpack(body).parameters & 7
                 for tag, _, body in chunks if tag == b"ALPM"), None)
    return tuple(c[0] for c in chunks[:2]), mode


def _encode(job):
    cfg_name, i = job
    cfg = load_config(cfg_name)
    drv = loop.load_driver(DRIVER, ROOT)
    img = drv.sheets(cfg)[i]
    b = bank.load_bank(os.path.join(ROOT, cfg["bank3d"]))
    t = time.time()
    s = encoder.encode_image(img, b, context.EncoderConfig(**cfg["encoder"]))
    return (i, s, time.time() - t, hashlib.sha256(img.tobytes()).hexdigest(),
            drv.transparent_tile_share(img))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("config", nargs="?", default="sprite2048")
    ap.add_argument("--workers", type=int, default=4)
    a = ap.parse_args(argv)
    cfg = load_config(a.config)
    n = cfg["sheets"]
    out = os.path.join(ROOT, cfg["pool"])
    os.makedirs(out, exist_ok=True)
    records = [None] * n
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(a.workers, n)) as pool:
        for i, s, sec, digest, share in pool.imap_unordered(
                _encode, [(a.config, i) for i in range(n)]):
            tags, mode = alpha_modes(s)
            want = (AlphaHeader.IS_8_BIT_FULL
                    if cfg["images"]["soft_edges"][i]
                    else AlphaHeader.IS_1_BIT_FULL)
            if tags != (b"MIPM", b"ALPM") or mode != want:
                raise SystemExit(f"page {i}: chunks {tags}, ALPM mode "
                                 f"{mode}; wanted MIPM, ALPM mode {want}")
            with open(os.path.join(out, f"{i:03d}.yaik"), "wb") as f:
                f.write(s)
            records[i] = {"file": f"{i:03d}.yaik", "bytes": len(s),
                          "image_sha256": digest, "alpm": MODES[mode],
                          "transparent_tile_share": round(share, 4),
                          "encode_s": round(sec, 2)}
            print(f"{i:03d}: {len(s)} bytes, {MODES[mode]} ALPM, "
                  f"{100 * share:.1f}% transparent tiles, in {sec:.1f} s",
                  flush=True)
    prov = {"config": a.config, "generator": "portbench/drivers/"
            "encode_image_rgba.py sheets (shelf-packed silhouettes over "
            "make_main)", "images": cfg["images"], "sheets": n,
            "height": cfg["height"], "width": cfg["width"],
            "encoder": "portbench/reference/encoder.py (pure Python, "
                       "no native code)", "encoder_config": cfg["encoder"],
            "zstd_version": int(zstd.VERSION), "numpy": np.__version__,
            "python": platform.python_version(),
            "command": f"python3 portbench/gen/make_sprite_pool.py {a.config}",
            "streams": records}
    with open(os.path.join(out, "PROVENANCE.json"), "w") as f:
        json.dump(prov, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
