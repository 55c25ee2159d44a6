"""Make the `mipchain1024` configuration's committed stream pool with the
plain encoder.

    python3 portbench/gen/make_mip_pool.py [mipchain1024] [--workers 4]

Encodes every level of every texture of the configuration
(`drivers/encode_mipchain.py` `textures` and `chain`) with the frozen pure-Python
host encoder (`reference.encoder`), on `workers` processes, the largest
levels first, and writes `<pool>/TT-LL.yaik` (texture TT, level LL, 00 the
top level) and `<pool>/PROVENANCE.json` (each stream's size, chunk tags,
MIPM presence, ALPM mode, the share of wholly transparent 16x16 tiles
(null below 16 px) and encode time).
Checks that every top level writes MIPM. Runs on the CPU; imports nothing
of the port.
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
from portbench.gen.make_sprite_pool import MODES  # noqa: E402
from portbench.harness import loop  # noqa: E402
from portbench.reference import bank, context, decoder  # noqa: E402
from portbench.reference import encoder, zstd  # noqa: E402
from portbench.reference.headers import AlphaHeader  # noqa: E402

DRIVER = "encode_mipchain"


def _encode(job):
    cfg_name, t, lv = job
    cfg = load_config(cfg_name)
    drv = loop.load_driver(DRIVER, ROOT)
    img = drv.chain(drv.textures(cfg)[t], cfg["levels"])[lv]
    b = bank.load_bank(os.path.join(ROOT, cfg["bank3d"]))
    t0 = time.time()
    s = encoder.encode_image(img, b, context.EncoderConfig(**cfg["encoder"]))
    share = (loop.load_driver("encode_image_rgba", ROOT)
             .transparent_tile_share(img) if img.shape[0] >= 16 else None)
    return (t, lv, s, time.time() - t0,
            hashlib.sha256(img.tobytes()).hexdigest(), share)


def describe(stream: bytes) -> dict:
    """The stream's chunk tags, whether it writes MIPM, its ALPM mode."""
    chunks = list(decoder.iter_chunks(stream))
    mode = next((AlphaHeader.unpack(body).parameters & 7
                 for tag, _, body in chunks if tag == b"ALPM"), None)
    tags = [c[0].decode() for c in chunks]
    return {"chunks": tags, "mipm": "MIPM" in tags,
            "alpm": MODES.get(mode, mode)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("config", nargs="?", default="mipchain1024")
    ap.add_argument("--workers", type=int, default=4)
    a = ap.parse_args(argv)
    cfg = load_config(a.config)
    nt, levels = cfg["textures"], cfg["levels"]
    out = os.path.join(ROOT, cfg["pool"])
    os.makedirs(out, exist_ok=True)
    records = {}
    jobs = [(a.config, t, lv) for lv in range(len(levels))
            for t in range(nt)]                   # largest levels first
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(a.workers, len(jobs))) as pool:
        for t, lv, s, sec, digest, share in pool.imap_unordered(
                _encode, jobs):
            name = f"{t:02d}-{lv:02d}.yaik"
            info = describe(s)
            if lv == 0 and not info["mipm"]:
                raise SystemExit(f"{name}: the top level writes no MIPM")
            with open(os.path.join(out, name), "wb") as f:
                f.write(s)
            records[name] = {"file": name, "side": levels[lv],
                             "bytes": len(s), "image_sha256": digest,
                             **info,
                             "transparent_tile_share":
                                 None if share is None else round(share, 4),
                             "encode_s": round(sec, 2)}
            print(f"{name}: {levels[lv]}², {len(s)} bytes, {info}, "
                  f"transparent 16x16 tiles {share}, in {sec:.1f} s",
                  flush=True)
    prov = {"config": a.config, "generator": "portbench/drivers/"
            "encode_mipchain.py textures and chain (encode_image_rgba.py page, "
            "then a 2x2 box filter a level)", "images": cfg["images"],
            "textures": nt, "levels": levels,
            "encoder": "portbench/reference/encoder.py (pure Python, "
                       "no native code)", "encoder_config": cfg["encoder"],
            "zstd_version": int(zstd.VERSION), "numpy": np.__version__,
            "python": platform.python_version(),
            "command": f"python3 portbench/gen/make_mip_pool.py {a.config}",
            "streams": [records[k] for k in sorted(records)]}
    with open(os.path.join(out, "PROVENANCE.json"), "w") as f:
        json.dump(prov, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
