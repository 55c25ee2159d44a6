"""RGBA sprite-atlas pages through the port, on the CPU, against the
benchmark's frozen plain reference (`portbench/reference`).

Two 256x256 pages from the `sprite2048` configuration's page generator
(`portbench/drivers/encode_image_rgba.py`): a 4x4 shelf of 48-60 px
sprites, one page with anti-aliased edges and one with hard edges. For
each, the port's `encode_image` gives the reference encoder's stream in
canonical form, with an ALPM payload no larger than the reference's level
sweep makes it; the port's `decode_image` of the reference stream gives
the reference decoder's pixels; the streams hold MIPM then ALPM, 8-bit on
the soft page and 1-bit on the hard one. This file imports no jax.
"""
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import yaik_tpu_torch  # noqa: E402
from portbench.drivers import encode_image_rgba as drv  # noqa: E402
from portbench.reference import alpha as ref_alpha  # noqa: E402
from portbench.reference import bank as ref_bank  # noqa: E402
from portbench.reference import canonical, context, decoder  # noqa: E402
from portbench.reference import encoder as ref_encoder, zstd  # noqa: E402
from portbench.reference.headers import AlphaHeader  # noqa: E402
from yaik_tpu_torch.encoder import bank as bankmod  # noqa: E402
from yaik_tpu_torch.encoder.context import EncoderConfig  # noqa: E402

DATA = ROOT / "portbench" / "data"
# (seed, soft edges, the ALPM mode the page writes)
PAGES = [(7, True, AlphaHeader.IS_8_BIT_FULL),
         (8, False, AlphaHeader.IS_1_BIT_FULL)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while these tests run (the suite runs several
    workers on the host's cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _encoder_settings() -> dict:
    with open(ROOT / "portbench" / "configs" / "sprite2048.json") as f:
        return json.load(f)["encoder"]


@pytest.fixture(scope="module")
def pages():
    """[(page, the reference's stream of it, ALPM mode wanted)]."""
    b3 = ref_bank.load_bank(str(DATA / "Bank3D"))
    cfg = context.EncoderConfig(**_encoder_settings())
    out = []
    for seed, soft, mode in PAGES:
        img = drv.page(seed, 256, 256, soft, sprite_px=(48, 60))
        out.append((img, ref_encoder.encode_image(img, b3, cfg), mode))
    return out


def _alpm(stream: bytes):
    """(ALPM header, compressed payload) of a stream."""
    for tag, _, body in decoder.iter_chunks(stream):
        if tag == b"ALPM":
            hdr = AlphaHeader.unpack(body)
            n = AlphaHeader.size()
            return hdr, body[n:n + hdr.stream_size]
    raise AssertionError("no ALPM chunk")


def test_pages_hold_mipm_then_alpm_in_their_modes(pages):
    for img, ref, mode in pages:
        assert img.shape == (256, 256, 4) and img.dtype == np.uint8
        assert not img[img[:, :, 3] == 0, :3].any()    # RGB cleaned
        tags = [c[0] for c in decoder.iter_chunks(ref)]
        assert tags[:2] == [b"MIPM", b"ALPM"], tags
        assert _alpm(ref)[0].parameters & 7 == mode
    soft, hard = pages[0][0], pages[1][0]
    assert len(np.unique(soft[:, :, 3])) > 2               # analog edges
    assert set(np.unique(hard[:, :, 3])) == {0, 255}
    assert drv.transparent_tile_share(soft) > 0


def test_port_encode_equals_the_reference(pages):
    b3 = bankmod.load_bank(str(DATA / "Bank3D"))
    cfg = EncoderConfig(**_encoder_settings())
    for img, ref, _ in pages:
        got = yaik_tpu_torch.encode_image(img, b3, device="cpu", config=cfg)
        assert canonical.canonical(got) == canonical.canonical(ref)
        hdr, payload = _alpm(got)
        raw = zstd.decompress(payload, hdr.expected_decompression_size)
        assert len(payload) <= len(ref_alpha._zstd_sweep(raw))


def test_port_decode_equals_the_reference(pages):
    lut = (DATA / "LutFile.lut").read_bytes()
    bank = yaik_tpu_torch.assign_lut(lut)
    for _, ref, _ in pages:
        got = yaik_tpu_torch.decode_image(ref, bank, device="cpu")
        want = decoder.decode(ref, lut)
        assert got.shape == want.shape == (256, 256, 4)
        assert np.array_equal(got, want)
