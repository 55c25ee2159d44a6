"""Make a configuration's committed stream pool with the plain encoder.

    python3 portbench/gen/make_pool.py illust512 [--workers 6]

Encodes every image of `gen.images.config_images(config)` with the frozen
pure-Python host encoder (`reference.encoder`, ~26 s a 512x512 image on
one core), on `workers` processes, and writes `<pool>/NNN.yaik` and
`<pool>/PROVENANCE.json`. Runs on the CPU; imports nothing of the port.
The decode cells read these streams as their inputs, and the encode cells
hold the port's streams to them, decompressed.
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

from portbench.gen import images  # noqa: E402
from portbench.reference import bank, context, encoder, zstd  # noqa: E402


def load_config(name: str) -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        return json.load(f)


def _encode(job):
    cfg_name, i = job
    cfg = load_config(cfg_name)
    img = images.config_images(cfg)[i]
    b = bank.load_bank(os.path.join(ROOT, cfg["bank3d"]))
    t = time.time()
    s = encoder.encode_image(img, b, context.EncoderConfig(**cfg["encoder"]))
    return i, s, time.time() - t, hashlib.sha256(img.tobytes()).hexdigest()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--workers", type=int, default=4)
    a = ap.parse_args(argv)
    cfg = load_config(a.config)
    n = cfg["images"]["bases"] * cfg["images"]["variants"]
    out = os.path.join(ROOT, cfg["pool"])
    os.makedirs(out, exist_ok=True)
    records = [None] * n
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(a.workers) as pool:
        for i, s, sec, digest in pool.imap_unordered(
                _encode, [(a.config, i) for i in range(n)]):
            with open(os.path.join(out, f"{i:03d}.yaik"), "wb") as f:
                f.write(s)
            records[i] = {"file": f"{i:03d}.yaik", "bytes": len(s),
                          "image_sha256": digest,
                          "encode_s": round(sec, 2)}
            print(f"{i:03d}: {len(s)} bytes in {sec:.1f} s", flush=True)
    prov = {"config": a.config, "generator": "portbench/gen/images.py "
            "config_images (make_main + variant)",
            "images": cfg["images"], "height": cfg["height"],
            "width": cfg["width"],
            "encoder": "portbench/reference/encoder.py (pure Python, "
                       "no native code)", "encoder_config": cfg["encoder"],
            "zstd_version": int(zstd.VERSION), "numpy": np.__version__,
            "python": platform.python_version(),
            "command": f"python3 portbench/gen/make_pool.py {a.config}",
            "streams": records}
    with open(os.path.join(out, "PROVENANCE.json"), "w") as f:
        json.dump(prov, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
