"""The plain reference's RGB paths, held to digests taken before it learned
the alpha chunks: the reference decoder's pixels and the canonical form of
every committed stream of `portbench/data/`, and the frozen encoder's
streams of the 128x128 RGB images the CPU harness tests encode.

    python -m pytest portbench/tests/test_portbench_rgb_guard.py -q

`python3 portbench/tests/test_portbench_rgb_guard.py` rewrites the digests
from the reference as it stands; only a change that means to alter what the
reference decodes or encodes may do that.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.reference import canonical, decoder, zstd  # noqa: E402

DIGESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "rgb_digests.json")
POOLS = ("illust512", "illust4k")


def _lut() -> bytes:
    with open(os.path.join(ROOT, "portbench", "data", "LutFile.lut"),
              "rb") as f:
        return f.read()


def committed_streams() -> list:
    """Paths, relative to the checkout, of every committed pool stream."""
    out = []
    for pool in POOLS:
        d = os.path.join("portbench", "data", pool)
        out += [os.path.join(d, n) for n in
                sorted(os.listdir(os.path.join(ROOT, d)))
                if n.endswith(".yaik")]
    return out


def form_digest(stream: bytes) -> str:
    return hashlib.sha256(repr(canonical.canonical(stream)).encode()
                          ).hexdigest()


def pixels_digest(px) -> str:
    return hashlib.sha256(repr(px.shape).encode() + px.tobytes()).hexdigest()


def tiny_rgb_streams() -> list:
    """The frozen encoder's streams of the CPU harness tests' three 128x128
    RGB images (illust512's generator and encoder settings)."""
    from portbench.gen import images
    from portbench.reference import bank, context, encoder
    with open(os.path.join(ROOT, "portbench/configs/illust512.json")) as f:
        cfg = json.load(f)
    cfg.update(height=128, width=128)
    cfg["images"].update(bases=3, variants=1)
    b3 = bank.load_bank(os.path.join(ROOT, "portbench/data/Bank3D"))
    return [encoder.encode_image(img, b3,
                                 context.EncoderConfig(**cfg["encoder"]))
            for img in images.config_images(cfg)]


def _load() -> dict:
    with open(DIGESTS) as f:
        return json.load(f)


def test_every_committed_stream_has_a_digest():
    assert sorted(_load()["streams"]) == sorted(committed_streams())
    assert len(committed_streams()) == 68


@pytest.mark.parametrize("rel", committed_streams())
def test_committed_stream_decodes_and_canonicalises_as_before(rel):
    want = _load()["streams"][rel]
    with open(os.path.join(ROOT, rel), "rb") as f:
        s = f.read()
    assert form_digest(s) == want["canonical"]
    assert pixels_digest(decoder.decode(s, _lut())) == want["pixels"]


def test_frozen_encoder_rgb_streams_as_before():
    """Same canonical form always; the same bytes where the libzstd is the
    one the digests were taken with (compressed bytes are the library's)."""
    want = _load()["tiny_rgb"]
    streams = tiny_rgb_streams()
    assert [form_digest(s) for s in streams] == want["canonical"]
    if zstd.VERSION == want["zstd_version"]:
        assert [hashlib.sha256(s).hexdigest() for s in streams] == \
            want["bytes"]


def main() -> None:
    lut = _lut()
    out = {"streams": {}, "tiny_rgb": {"zstd_version": zstd.VERSION}}
    for rel in committed_streams():
        with open(os.path.join(ROOT, rel), "rb") as f:
            s = f.read()
        out["streams"][rel] = {"canonical": form_digest(s),
                               "pixels": pixels_digest(decoder.decode(s, lut))}
        print(rel, flush=True)
    streams = tiny_rgb_streams()
    out["tiny_rgb"]["canonical"] = [form_digest(s) for s in streams]
    out["tiny_rgb"]["bytes"] = [hashlib.sha256(s).hexdigest()
                                for s in streams]
    with open(DIGESTS, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
