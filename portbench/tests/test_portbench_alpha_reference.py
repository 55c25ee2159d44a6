"""The plain reference's alpha chunks (`reference/alpha.py`, MIPM and ALPM in
the decoder, the canonical form and the encoder), held to what the JAX
package's host code gives on the CPU, frozen as digests in
`jax_alpha_digests.json` (`test_portbench_alpha_port.py` holds the port to
the reference):

    python -m pytest portbench/tests/test_portbench_alpha_reference.py -q

Nothing here imports JAX, the JAX package or the port.
"""
from __future__ import annotations

import os

import numpy as np
import pytest

from rgba_inputs import (ALPHA_CASES, CASES, FIX, RGBA, form_digest,
                         jax_digests, pixels_digest, read_fixture, read_lut,
                         reference_bank, rgba_case)
from portbench.reference import alpha, canonical, decoder, zstd
from portbench.reference.context import EncoderConfig, _chunk
from portbench.reference.headers import AlphaHeader


@pytest.fixture(scope="module")
def lut() -> bytes:
    return read_lut()


def _tags(stream: bytes) -> list:
    return [t for t, _, _ in decoder.iter_chunks(stream)]


def test_digests_cover_every_fixture_and_case():
    d = jax_digests()
    assert sorted(d["decode"]) == sorted(RGBA)
    assert sorted(d["encode"]) == CASES


@pytest.mark.parametrize("name", RGBA)
def test_decode_equals_the_jax_package_host_decoder(name, lut):
    import hashlib
    want = jax_digests()["decode"][name]
    s = read_fixture(name)
    assert hashlib.sha256(s).hexdigest() == want["stream_sha256"]
    got = decoder.decode(s, lut)
    assert list(got.shape) == want["shape"] and got.shape[2] == 4
    assert got.dtype == np.uint8
    assert pixels_digest(got) == want["pixels"]
    if name == "bench_rgba512":
        gold = np.load(os.path.join(FIX, name + ".dec.npz"))
        np.testing.assert_array_equal(got, gold[list(gold.keys())[0]])


def test_fixtures_hold_both_alpha_chunks_and_every_mode():
    tags = {n: _tags(read_fixture(n)) for n in RGBA}
    assert any(b"MIPM" in t for t in tags.values())
    assert all(b"ALPM" in t for n, t in tags.items()
               if n != "alpha64_const255")
    modes = set()
    for n in RGBA:
        for tag, _, body in decoder.iter_chunks(read_fixture(n)):
            if tag == b"ALPM":
                modes.add(AlphaHeader.unpack(body).parameters & 7)
    assert modes >= {AlphaHeader.IS_1_BIT_FULL, AlphaHeader.IS_8_BIT_FULL,
                     AlphaHeader.IS_6_BIT_FULL_INVERSE,
                     AlphaHeader.IS_6_BIT_USEMIPMAPMASK_INVERSE}, modes


def _alpm_payload_altered(stream: bytes, k: int) -> bytes:
    """`stream` with byte k of its ALPM payload flipped and recompressed."""
    out = bytearray(stream[:decoder.FileHeader.size()])
    for tag, off, body in decoder.iter_chunks(stream):
        if tag == b"ALPM":
            hdr = AlphaHeader.unpack(body)
            n = AlphaHeader.size()
            raw = bytearray(zstd.decompress(body[n:n + hdr.stream_size],
                                            hdr.expected_decompression_size))
            raw[k % len(raw)] ^= 0x04
            z = zstd.compress(bytes(raw), 5)
            hdr.stream_size = len(z)
            body = hdr.pack() + z
        out += _chunk(tag, body)
    return bytes(out) + (0xDEADBEEF).to_bytes(4, "little")


@pytest.mark.parametrize("name", RGBA)
def test_canonical_parses_and_sees_each_alpha_byte(name):
    s = read_fixture(name)
    form = canonical.canonical(s)
    tags = [c[0] for c in form[1:]]
    assert tags == _tags(s)
    if b"ALPM" not in tags:
        return
    for k in (0, 7, 10 ** 9):
        assert canonical.canonical(_alpm_payload_altered(s, k)) != form
    # bytes past the payload raise
    for tag, off, body in decoder.iter_chunks(s):
        if tag in (b"ALPM", b"MIPM"):
            hb = off - 8
            bad = (s[:hb] + _chunk(tag, body + b"\0\0\0\x01")
                   + s[off + len(body):])
            with pytest.raises(ValueError):
                canonical.canonical(bad)


def test_canonical_ignores_the_alpm_level():
    s = read_fixture("sprite256")
    pieces = [s[:decoder.FileHeader.size()]]
    for tag, off, body in decoder.iter_chunks(s):
        if tag == b"ALPM":
            hdr = AlphaHeader.unpack(body)
            n = AlphaHeader.size()
            z = body[n:n + hdr.stream_size]
            raw = zstd.decompress(z, hdr.expected_decompression_size)
            z2 = zstd.compress(raw, 1)
            assert z2 != z
            hdr.stream_size = len(z2)
            body = hdr.pack() + z2
        pieces.append(_chunk(tag, body))
    other = b"".join(pieces) + (0xDEADBEEF).to_bytes(4, "little")
    assert other != s
    assert canonical.canonical(other) == canonical.canonical(s)


@pytest.mark.parametrize("case", CASES)
def test_encoder_equals_the_jax_package_host_encode(case):
    from portbench.reference import encoder
    want = jax_digests()["encode"][case]
    got = encoder.encode_image(rgba_case(case), reference_bank(),
                               EncoderConfig(**ALPHA_CASES[case][0]))
    form = canonical.canonical(got)
    assert [c[0].decode() for c in form[1:]] == want["chunks"]
    assert form_digest(form) == want["form"]
    assert decoder.FileHeader.unpack(got).has_alpha


def test_encoder_rgb_of_an_rgba_image_is_the_rgb_stream():
    """The RGB passes score the first three channels alone: an RGBA
    image's stream is the RGB image's with has_alpha set and the alpha
    chunks ahead of the gradient chunks."""
    from portbench.reference import encoder
    img = rgba_case("sparse")
    b3 = reference_bank()
    rgba = canonical.canonical(encoder.encode_image(img, b3))
    rgb = canonical.canonical(encoder.encode_image(
        np.ascontiguousarray(img[:, :, :3]), b3))
    assert rgba[0][4] == 1 and rgb[0][4] == 0
    assert [c[0] for c in rgba[1:3]] == [b"MIPM", b"ALPM"]
    assert rgba[3:] == rgb[1:]


def test_mip_prefilter_and_pack6_round_trip():
    rng = np.random.default_rng(2 ** 31 + 5)
    a = rng.integers(0, 256, (48, 80)).astype(np.uint8)
    a[:, :16] = 0               # a transparent column of tiles, and two
    a[:16, 16:48] = 0           # tiles inside the kept tiles' bbox
    mask, chunk, bound = alpha.mip_prefilter(a)
    assert chunk is not None and bound == (16, 0, 80, 48)
    assert not mask[:, :16].any() and not mask[:16, 16:48].any()
    assert mask[16:, 16:].all() and mask[:16, 48:].all()
    assert (alpha.decode_mipm(chunk[8:], 80, 48) == mask).all()
    v = rng.integers(0, 64, 1001).astype(np.uint8)
    raw = np.frombuffer(alpha._pack6(v), np.uint8)
    want = ((v.astype(np.uint32) << 2) | (v >> 4)).astype(np.uint8)
    assert (alpha._unpack6(raw, len(v), False) == want).all()
