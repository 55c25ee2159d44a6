"""The port at the image sides no fixture has, against the JAX package on
the CPU: 16-px-wide images (the 16-wide 3D pass has one tile column) and
sides with w % 16 == 8 or h % 16 == 8 (the last 16-wide tile column is
half a tile), as the crops of tests/torch_streams.py's EDGE_CROPS.

The JAX package's native gradient emission indexes its accept grid with
ceil(w / tw) columns where the grid has floor(w / tw), so at w % 16 == 8
its default encode writes the wrong tiles; its pure-Python emission is the
reference here (`yaik_tpu.native.available` off, read at call time). At
w % 16 == 0 both of its emissions agree, and the 16-wide crops are held to
its default `engine="device"` encode. Every comparison is exact: bytes of
streams run through one zstd in this process, pixels of decodes.

tests/fixtures/edge_digests.json holds, per crop, the byte length of the
JAX package's stream and the sha256 of its reference decode; chip_smoke.py
holds the card's decodes to them. `JAX_PLATFORMS=cpu python
tests/test_torch_edge_shapes.py` writes the file anew, and
`test_edge_digest_is_current` recomputes each entry.
"""
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIX = ROOT / "tests" / "fixtures"
DIGESTS = FIX / "edge_digests.json"
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT))

import yaik_tpu  # noqa: E402
import yaik_tpu.native  # noqa: E402
from yaik_tpu.decoder import reference  # noqa: E402
from yaik_tpu.decoder.api import assign_lut as jax_assign_lut  # noqa: E402
from yaik_tpu.encoder import bank as jax_bankmod  # noqa: E402
from yaik_tpu.encoder.context import encode_image as jax_encode_image  # noqa: E402,E501

import yaik_tpu_torch  # noqa: E402
from yaik_tpu_torch import native  # noqa: E402
from yaik_tpu_torch.encoder import api, batch, gradient  # noqa: E402
from yaik_tpu_torch.encoder import bank as bankmod  # noqa: E402
from yaik_tpu_torch.encoder.context import EncoderConfig  # noqa: E402
from yaik_tpu_torch.format import swizzle  # noqa: E402
from torch_streams import EDGE_CROPS, crop, digest, edge_crop  # noqa: E402

WIDE16 = [n for n, (_, _, w) in EDGE_CROPS.items() if w == 16]
HALF = [n for n, (_, _, w) in EDGE_CROPS.items() if w % 16 == 8]


def _jax_stream(name: str, python_emission: bool) -> bytes:
    bank = jax_bankmod.load_bank(str(FIX / "Bank3D"))
    with pytest.MonkeyPatch.context() as mp:
        if python_emission:
            mp.setattr(yaik_tpu.native, "available", lambda: False)
        return jax_encode_image(edge_crop(name), bank, engine="device")


def _jax_reference(name: str) -> tuple:
    """(stream, pixels): the JAX package's device encode of a crop through
    its Python emission, and its host decoder's pixels of that stream."""
    stream = _jax_stream(name, python_emission=True)
    lut = jax_assign_lut((FIX / "LutFile.lut").read_bytes(),
                         (FIX / "LutFile2D.lut").read_bytes())
    return stream, reference.decode(stream, lut.expanded, lut.expanded2d)


def write_edge_digests() -> None:
    out = {}
    for name in EDGE_CROPS:
        stream, pixels = _jax_reference(name)
        out[name] = {"bytes": len(stream), **digest(pixels)}
    DIGESTS.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while these tests run (the suite runs several
    workers on the host's cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def bank3d():
    return bankmod.load_bank(str(FIX / "Bank3D"))


@pytest.fixture(scope="module")
def jax_ref():
    """name -> (stream, pixels) of `_jax_reference`, and with
    python_emission=False the JAX package's default stream, each made once:
    a new shape costs the JAX engine a trace and a compile."""
    cache = {}

    def get(name, python_emission=True):
        if (name, python_emission) not in cache:
            cache[name, python_emission] = (
                _jax_reference(name) if python_emission
                else (_jax_stream(name, python_emission=False), None))
        return cache[name, python_emission]
    return get


@pytest.fixture(scope="module")
def port_stream(bank3d):
    """name -> the port's default encode_image(device="cpu") of a crop."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = yaik_tpu_torch.encode_image(edge_crop(name), bank3d,
                                                      device="cpu")
        return cache[name]
    return get


# -- (a) 16-px-wide images --------------------------------------------------

@pytest.mark.parametrize("entry", ["encode_image", "encode_batch"])
@pytest.mark.parametrize("name", WIDE16)
def test_16_wide_encode_equals_jax(name, entry, bank3d, port_stream,
                                   jax_ref):
    """A 16-wide image encodes (its 16x8 pass's operands were strided views
    the kernels refuse) to the bytes of the JAX package's default device
    encode, which at w % 16 == 0 its Python emission gives too."""
    want = jax_ref(name, python_emission=False)[0]
    assert want == jax_ref(name)[0]
    if entry == "encode_image":
        got = [port_stream(name)]
    else:
        got = batch.encode_batch([edge_crop(name)], bank3d, device="cpu")
    assert got == [want]


# -- (b) w % 16 == 8 ----------------------------------------------------------

@pytest.mark.parametrize("how", ["default, twice", "native off",
                                 "encode_batch"])
@pytest.mark.parametrize("name", HALF)
def test_half_tile_width_encode_equals_jax(name, how, bank3d, port_stream,
                                           jax_ref, monkeypatch):
    """At w % 16 == 8 every port path gives the JAX package's Python-
    emission bytes, call after call: the native emission is handed the
    [ceil(h / th), ceil(w / tw)] grid it indexes."""
    want = jax_ref(name)[0]
    img = edge_crop(name)
    if how == "default, twice":
        assert native.available()
        got = [port_stream(name),
               yaik_tpu_torch.encode_image(img, bank3d, device="cpu")]
    elif how == "native off":
        monkeypatch.setattr(native, "available", lambda: False)
        got = [yaik_tpu_torch.encode_image(img, bank3d, device="cpu")]
    else:
        got = batch.encode_batch([img, img.copy()], bank3d, device="cpu")
    assert all(g == want for g in got)


def test_half_tile_width_psnr(port_stream):
    """The 128x120 crop's default encode is the Python emission's 3,324
    bytes at 39.17 dB (the misread grid gave ~6,400 bytes at 24.7 dB)."""
    name = "img128_128x120"
    stream = port_stream(name)
    px = yaik_tpu_torch.decode_image(stream, yaik_tpu_torch.assign_lut(
        (FIX / "LutFile.lut").read_bytes()), device="cpu")
    mse = np.mean((px.astype(np.float64) - edge_crop(name)) ** 2)
    assert len(stream) == 3324
    assert round(10 * np.log10(255.0 ** 2 / mse), 2) == 39.17


# -- (c) the native emission against the Python one, pass by pass ----------

EMIT_CROPS = {40: ("sprite256", 72, 40), 56: ("img128", 72, 56),
              120: ("img128", 128, 120)}


def _emissions(w: int, fast: bool, bank) -> list:
    """Each gradient pass's (bitmap, stream, count, claims4 after it) of a
    crop, emitted from the scorer's accept grids as emit_image does, by
    emit_pass_fast (native) or emit_pass."""
    img = crop(*EMIT_CROPS[w])
    h = img.shape[0]
    planes = api._planes(img)
    cfg = EncoderConfig()
    accepts = api.score_image(img, bank, "cpu", cfg)[0]
    corners4 = gradient._corner_grids(planes, 4, 4).astype(np.int64)
    claims4 = np.zeros((h // 4, w // 4), bool)
    if fast:
        corner_bytes = np.ascontiguousarray(gradient.compress_f(
            gradient.round6(corners4),
            cfg.color_compression_quad).astype(np.uint8))
        mapped4 = np.zeros((3, h // 4 + 1, w // 4 + 1), np.uint8)
        claims4 = claims4.view(np.uint8)
    else:
        claims = np.zeros((3, h, w), bool)
        mapped_rgb = np.zeros((3, h + 1, w + 1), bool)
    out = []
    for k, (sx, sy) in enumerate(swizzle.GRADIENT_PASS_ORDER):
        if fast:
            bitmap, stream, count, _ = gradient.emit_pass_fast(
                accepts[k], sx, sy, w, h, corner_bytes, mapped4, claims4)
        else:
            bitmap, stream, count = gradient.emit_pass(
                planes, claims, mapped_rgb, accepts[k], sx, sy,
                cfg.color_compression_quad, corners4=corners4,
                claims4=claims4)
        out.append((bitmap and bytes(bitmap), stream and bytes(stream),
                    count, claims4.astype(bool)))
    return out


@pytest.fixture(scope="module")
def emissions(bank3d):
    cache = {}

    def get(w, fast):
        if (w, fast) not in cache:
            cache[w, fast] = _emissions(w, fast, bank3d)
        return cache[w, fast]
    return get


@pytest.mark.parametrize("k", range(len(swizzle.GRADIENT_PASS_ORDER)))
@pytest.mark.parametrize("w", sorted(EMIT_CROPS))
def test_emit_pass_fast_equals_emit_pass(w, k, emissions):
    assert native.available()
    fast, slow = emissions(w, True)[k], emissions(w, False)[k]
    assert fast[:3] == slow[:3]
    assert np.array_equal(fast[3], slow[3])
    if k == 0:
        assert any(e[2] for e in emissions(w, False))


# -- (d) the binding refuses a grid the library would misread ---------------

@pytest.mark.parametrize("grid", ["floor", "fortran", "bool", "strided"])
def test_emit_gtil_pass_refuses_a_wrong_grid(grid):
    w, h, sx, sy = 40, 24, 4, 3                 # a 16x8 pass: ceil 3 x 3
    acc = {"floor": np.zeros((3, 2), np.uint8),
           "fortran": np.zeros((3, 3), np.uint8, order="F"),
           "bool": np.zeros((3, 3), bool),
           "strided": np.zeros((3, 6), np.uint8)[:, ::2]}[grid]
    bx, by, _ = swizzle.swizzle_spec(sx, sy)
    with pytest.raises(ValueError, match="accept_u8"):
        native.emit_gtil_pass(
            acc, w, h, sx, sy, bx, by, np.zeros((3, 7, 11), np.uint8),
            np.zeros((3, 7, 11), np.uint8), None,
            np.zeros(swizzle.bitmap_size_bytes(sx, sy, w, h), np.uint8),
            np.zeros(256, np.uint8))


# -- (e) every decoder makes the same pixels of these streams ---------------

@pytest.fixture(scope="module")
def luts():
    lut = (FIX / "LutFile.lut").read_bytes()
    lut2d = (FIX / "LutFile2D.lut").read_bytes()
    from yaik_tpu_torch.native import capi
    clib = capi.CLibrary(max_instances=2)
    clib.assign_lut(lut)
    clib.assign_lut(lut2d)
    yield yaik_tpu_torch.assign_lut(lut, lut2d), clib
    clib.close()


DECODERS = ["split", "fused", "host", "C library"]


@pytest.mark.parametrize("decoder", DECODERS)
@pytest.mark.parametrize("name", list(EDGE_CROPS))
def test_edge_stream_decodes_alike(name, decoder, luts, port_stream,
                                   jax_ref):
    """The port's stream of a crop decodes to the JAX host decoder's
    pixels of the JAX package's stream, through each decoder."""
    bank, clib = luts
    stream = port_stream(name)
    if decoder == "C library":
        got = clib.decode(stream)
    else:
        kw = {"split": {"device": "cpu"},
              "fused": {"device": "cpu", "t3_d1": True, "grad_final": True},
              "host": {"engine": "host"}}[decoder]
        got = yaik_tpu_torch.decode_image(stream, bank, **kw)
    want = jax_ref(name)[1]
    assert got.shape == want.shape == edge_crop(name).shape
    assert np.array_equal(got, want)


# -- the committed reference values of chip_smoke's edge phase --------------

def test_edge_digest_entries_are_the_crops():
    assert sorted(json.loads(DIGESTS.read_text())) == sorted(EDGE_CROPS)


@pytest.mark.parametrize("name", list(EDGE_CROPS))
def test_edge_digest_is_current(name, jax_ref):
    stream, pixels = jax_ref(name)
    assert json.loads(DIGESTS.read_text())[name] == {"bytes": len(stream),
                                                     **digest(pixels)}


if __name__ == "__main__":
    write_edge_digests()
