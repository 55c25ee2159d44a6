"""RGBA encode, the passes the reference leaves disabled, and the PLNT plane
decode of the port (yaik_tpu_torch) against the JAX package on the CPU.

Whole streams: `yaik_tpu_torch.encode_image(device="cpu")` against
`yaik_tpu.encoder.context.encode_image(engine="device")` run in this
process (same zstd), for RGBA images (the five 64x64 alpha cases: 1-, 6-
and 8-bit, constant, sparse with its MIPM chunk; and sprite256), the 2D
passes on corr2d128 (each other pass alone on img64 is
tests/test_torch_encode.py's `test_encode_outside_the_slice_raises`) and
every pass together on gradpair192. The batch entry points against the
port's `encode_image` on RGBA images and with the passes on; the round trip
of the new streams through the port's `decode_image` against the JAX
package's host decoder; the PLNT plane (`pack.plnt_args` +
`engine.decode_plnt_plane`) against `jax_engine`'s pair and the host plane.
Every comparison is exact, tolerance 0: streams are bytes, planes and
pixels integers.
"""
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image

from torch_streams import ALPHA_CASES, rgba_case
from yaik_tpu.decoder import jax_engine
from yaik_tpu.decoder import reference as decref
from yaik_tpu.decoder.api import assign_lut as jax_assign_lut
from yaik_tpu.encoder import bank as bankmod
from yaik_tpu.encoder import bank2d as jax_bank2d
from yaik_tpu.encoder.context import EncoderConfig
from yaik_tpu.encoder.context import encode_image as jax_encode_image
from yaik_tpu.format.headers import PlaneTile
import yaik_tpu_torch
from yaik_tpu_torch.decoder import engine, pack
from yaik_tpu_torch.encoder import batch, bank2d

FIX = pathlib.Path(__file__).parent / "fixtures"
ALL_PASSES = dict(enable_single_color=True, enable_smooth_map=True,
                  enable_2d=True, enable_plnt=True,
                  enable_plane_gradients=True)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while these tests run, as in
    tests/test_torch_encode_batch.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def bank():
    return bankmod.load_bank(str(FIX / "Bank3D"))


@pytest.fixture(scope="module")
def banks2d():
    """(the port's Bank2D, the JAX package's) of tests/fixtures/Bank2D."""
    return (bank2d.load_bank2d(str(FIX / "Bank2D")),
            jax_bank2d.load_bank2d(str(FIX / "Bank2D")))


def _png(name):
    return np.asarray(Image.open(FIX / f"{name}.png"))


# name -> (image, EncoderConfig keywords)
CASES = {**{f"alpha64_{n}": (lambda n=n: rgba_case(n), ALPHA_CASES[n][0])
            for n in sorted(ALPHA_CASES)},
         "sprite256": (lambda: _png("sprite256"), {}),
         "corr2d128_2d": (lambda: _png("corr2d128"), dict(enable_2d=True)),
         "gradpair192_all": (lambda: _png("gradpair192"), ALL_PASSES)}
_STREAMS: dict = {}


def _stream(name, bank, banks2d) -> bytes:
    """The port's stream of case `name` (made once per process)."""
    if name not in _STREAMS:
        img, kw = CASES[name]
        _STREAMS[name] = yaik_tpu_torch.encode_image(
            img(), bank, device="cpu", config=EncoderConfig(**kw),
            bank2d=banks2d[0] if kw.get("enable_2d") else None)
    return _STREAMS[name]


def _tags(stream: bytes) -> list:
    return [t for t, _, _ in decref.iter_chunks(stream)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_encode_equals_the_jax_package(name, bank, banks2d):
    img, kw = CASES[name]
    want = jax_encode_image(img(), bank, EncoderConfig(**kw),
                            engine="device",
                            bank2d=banks2d[1] if kw.get("enable_2d")
                            else None)
    got = _stream(name, bank, banks2d)
    assert got == want
    tags = _tags(got)
    if name == "alpha64_const255":
        assert b"ALPM" not in tags          # constant alpha: no chunk
    elif name.startswith(("alpha64", "sprite")):
        assert b"ALPM" in tags
    if name == "alpha64_sparse":                        # the mipmap chunk
        assert tags[:2] == [b"MIPM", b"ALPM"]
    if name == "gradpair192_all":
        for t in (b"UCOL", b"SMAP", b"2DTL", b"PLNT"):
            assert t in tags
        assert tags.index(b"PLNT") > tags.index(b"1DTL")
        assert sum(t == b"GTIL" for t in tags) > 7      # plane-subset passes


@pytest.mark.parametrize("name", sorted(CASES))
def test_round_trip_decodes_to_the_jax_decoders_pixels(name, bank, banks2d):
    """The port's stream through the port's decode_image equals the JAX
    package's host decoder; where the alpha chunk is 8-bit the alpha
    channel comes back as the source's."""
    stream = _stream(name, bank, banks2d)
    lut = (FIX / "LutFile.lut").read_bytes()
    lut2d = (FIX / "LutFile2D.lut").read_bytes()
    jbank = jax_assign_lut(lut, lut2d)
    want = decref.decode(stream, jbank.expanded, jbank.expanded2d)
    got = yaik_tpu_torch.decode_image(
        stream, yaik_tpu_torch.assign_lut(lut, lut2d), device="cpu")
    assert np.array_equal(got, want)
    img, kw = CASES[name]
    if name in ("alpha64_8bit", "sprite256"):
        assert np.array_equal(got[:, :, 3], img()[:, :, 3])


def test_decoding_a_2d_stream_needs_the_lut2d(bank, banks2d):
    """A 2DTL stream of the port's encoder needs the 2D LUT to decode."""
    stream = _stream("corr2d128_2d", bank, banks2d)
    with pytest.raises(ValueError):
        yaik_tpu_torch.decode_image(
            stream, yaik_tpu_torch.assign_lut(
                (FIX / "LutFile.lut").read_bytes()), device="cpu")


def test_encode_batch_takes_rgba(bank):
    imgs = [rgba_case("8bit"), rgba_case("sparse")]
    cfg = EncoderConfig(alpha_force_8bit=False)
    want = [yaik_tpu_torch.encode_image(im, bank, device="cpu", config=cfg)
            for im in imgs]
    assert batch.encode_batch(imgs, bank, cfg, device="cpu") == want


def test_encode_corpus_takes_mixed_rgb_and_rgba(bank):
    """RGB and RGBA images of one size in one corpus: each stream equals
    encode_image's, in input order."""
    imgs = [rgba_case("1bit"), _png("img64"), rgba_case("8bit"),
            255 - _png("img64")]
    want = [yaik_tpu_torch.encode_image(im, bank, device="cpu")
            for im in imgs]
    assert batch.encode_corpus(imgs, bank, batch_size=2,
                               device="cpu") == want


def test_encode_image_banded_takes_rgba(bank):
    img = rgba_case("6bit")
    cfg = EncoderConfig(**ALPHA_CASES["6bit"][0])
    want = yaik_tpu_torch.encode_image(img, bank, device="cpu", config=cfg)
    assert batch.encode_image_banded(img, bank, cfg, device="cpu",
                                     band_rows=16) == want


@pytest.mark.parametrize("entry", ["encode_batch", "encode_corpus",
                                   "encode_image_banded"])
def test_batch_entry_points_run_the_disabled_passes(entry, bank):
    """Every pass but 2D (the batch entry points take no 2D bank) on an
    RGBA image: the streams equal encode_image's."""
    kw = {k: v for k, v in ALL_PASSES.items() if k != "enable_2d"}
    cfg = EncoderConfig(**kw)
    img = np.concatenate([_png("img64"), rgba_case("sparse")[:, :, 3:]], 2)
    want = yaik_tpu_torch.encode_image(img, bank, device="cpu", config=cfg)
    fn = getattr(batch, entry)
    got = (fn(img, bank, cfg, device="cpu", band_rows=32)
           if entry == "encode_image_banded"
           else fn([img], bank, cfg, device="cpu")[0])
    assert got == want


def test_encode_2d_without_bank2d_raises(bank):
    with pytest.raises(ValueError, match="enable_2d requires a bank2d"):
        yaik_tpu_torch.encode_image(_png("img64"), bank, device="cpu",
                                    config=EncoderConfig(enable_2d=True))


def test_jax_bank2d_is_taken(bank, banks2d):
    """encode_image takes the JAX package's Bank2D as well as the port's."""
    img = _png("img64")
    cfg = EncoderConfig(enable_2d=True)
    got = [yaik_tpu_torch.encode_image(img, bank, device="cpu", config=cfg,
                                       bank2d=b) for b in banks2d]
    assert got[0] == got[1] and b"2DTL" in _tags(got[0])


def _plnt_chunks(data: bytes):
    for tag, _, body in decref.iter_chunks(data):
        if tag == b"PLNT":
            hdr = PlaneTile.unpack(body)
            yield hdr, body[PlaneTile.size():]


def _plane(args) -> np.ndarray:
    luts, codes, vmask, nty, ntx = args
    return engine.decode_plnt_plane(
        *(torch.from_numpy(a) for a in (luts, codes, vmask)), nty,
        ntx).numpy()


@pytest.mark.parametrize("name", ["img64", "corr2d128"])
def test_plnt_plane_equals_the_jax_package_and_host(name):
    """plnt_args equals jax_engine.plnt_device_args array by array, and the
    plane equals decode_plnt_plane_device's and the host decoder's, on
    every PLNT chunk of the committed streams (as tests/test_plnt.py's
    test_plnt_device_plane_matches_host)."""
    n = 0
    for hdr, pb in _plnt_chunks((FIX / f"{name}.plnt.yaik").read_bytes()):
        host, _ = decref.decode_plnt_plane(hdr, pb)
        args = pack.plnt_args(hdr, pb)
        want = jax_engine.plnt_device_args(hdr, pb)
        for a, b in zip(args, want):
            assert np.array_equal(a, b)
        got = _plane(args)
        assert np.array_equal(got, np.asarray(
            jax_engine.decode_plnt_plane_device(*want[:3], nty=want[3],
                                                ntx=want[4])))
        assert np.array_equal(got, host[hdr.y:hdr.y + hdr.h,
                                        hdr.x:hdr.x + hdr.w])
        n += 1
    assert n == 3     # Y, Co, Cg


def test_plnt_plane_with_a_mask_equals_the_jax_package(bank):
    """An RGBA image whose alpha is zero on all but two 16x16 tiles: its
    PLNT chunks are coded under the mipmap mask, and with the mask
    plnt_args and the plane equal the JAX package's pair, -999 where the
    mask leaves pixels unwritten."""
    img = np.concatenate([_png("img64"), np.zeros((64, 64, 1), np.uint8)], 2)
    img[:16, :16, 3] = 200
    img[48:, 48:, 3] = 100
    stream = yaik_tpu_torch.encode_image(
        img, bank, device="cpu", config=EncoderConfig(enable_plnt=True))
    valid = np.zeros((64, 64), bool)
    valid[:16, :16] = valid[48:, 48:] = True
    n = 0
    for hdr, pb in _plnt_chunks(stream):
        args = pack.plnt_args(hdr, pb, valid)
        want = jax_engine.plnt_device_args(hdr, pb, valid)
        for a, b in zip(args, want):
            assert np.array_equal(a, b)
        got = _plane(args)
        assert (got == -999).any() and (got != -999).any()
        assert np.array_equal(got, np.asarray(
            jax_engine.decode_plnt_plane_device(*want[:3], nty=want[3],
                                                ntx=want[4])))
        n += 1
    assert n == 3


def test_decode_image_skips_plnt(bank):
    """decode_image skips PLNT chunks: a stream with them decodes to the
    pixels of the same stream without."""
    img = _png("img64")
    lut = yaik_tpu_torch.assign_lut((FIX / "LutFile.lut").read_bytes())
    with_plnt = yaik_tpu_torch.encode_image(
        img, bank, device="cpu", config=EncoderConfig(enable_plnt=True))
    plain = yaik_tpu_torch.encode_image(img, bank, device="cpu")
    assert b"PLNT" in _tags(with_plnt)
    assert np.array_equal(
        yaik_tpu_torch.decode_image(with_plnt, lut, device="cpu"),
        yaik_tpu_torch.decode_image(plain, lut, device="cpu"))
