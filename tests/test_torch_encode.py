"""The port's device-scored encode (yaik_tpu_torch.encode_image) against the
JAX package: each module on the same operands as its JAX counterpart
(gradient scoring, the dense 3D pass, the bank tables, 3D emission), and
whole streams against `context.encode_image` run in the same process
(same zstd library). Exact comparisons, tolerance 0: the port's
arithmetic is int32 wrapping as the JAX package's does, and the one float
normalization divides by a power of two.

On the CPU the scoring kernels run their plain versions;
tests/test_torch_cuda.py encodes on the card.
"""
import inspect
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

import yaik_tpu_torch
from yaik_tpu.encoder import bank as bankmod
from yaik_tpu.encoder import bank2d as jax_bank2d
from yaik_tpu.encoder import device_pipeline as devp
from yaik_tpu.encoder import jax_scoring as js
from yaik_tpu.encoder.context import EncoderConfig
from yaik_tpu.encoder.context import encode_image as jax_encode_image
from yaik_tpu.format import swizzle
from yaik_tpu_torch.encoder import api, bank2d, emit, scoring, tables
from yaik_tpu_torch.ops import kernels

FIX = pathlib.Path(__file__).parent / "fixtures"
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def bank():
    return bankmod.load_bank(str(FIX / "Bank3D"))


def _image(name):
    return np.asarray(Image.open(FIX / f"{name}.png"))


def _planes(img):
    return img.transpose(2, 0, 1).astype(np.int32)


def test_bank_tables_match_bank_device_tables(bank):
    want = devp.bank_device_tables(bank)
    got = tables.bank_tables(bank)
    assert bank.count == 12
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        assert np.array_equal(g, np.asarray(w))
    dev = tables.device_tables(bank, CPU)
    assert dev is tables.device_tables(bank, CPU)       # built once
    assert all(torch.equal(t, torch.from_numpy(a)) for t, a in zip(dev, got))


@pytest.mark.parametrize("name", ["img64", "quilt128"])
def test_gradient_all_matches_jax(name):
    planes = _planes(_image(name))
    claims = torch.zeros(planes.shape, dtype=torch.bool)
    got = scoring.gradient_all(torch.from_numpy(planes), claims, 3)
    want, jclaims = js.gradient_all_device(
        jnp.asarray(planes), jnp.zeros(planes.shape, bool), 3)
    assert len(got) == 7 and any(a.any() for a in got)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert np.array_equal(claims.numpy(), np.asarray(jclaims))


@pytest.mark.parametrize("name", ["img64", "img128"])
def test_tile3d_passes_match_resident(name, bank):
    """All six dense 3D passes after the gradient claims, claims evolving:
    accept, type, idx (dead pixels too), mask, mn, mx and the claims equal
    `tile3d_pass_resident` pass by pass."""
    planes = _planes(_image(name))
    tp = torch.from_numpy(planes)
    claims = torch.zeros(planes.shape, dtype=torch.bool)
    scoring.gradient_all(tp, claims, 3)
    jp = jnp.asarray(planes)
    _, jclaims = js.gradient_all_device(jp, jnp.zeros(planes.shape, bool), 3)
    jtables = devp.bank_device_tables(bank)
    ttables = tables.device_tables(bank, CPU)
    accepted = 0
    for (sx, sy) in swizzle.TILE3D_PASS_ORDER:
        want = js.tile3d_pass_resident(jp, jclaims, *jtables, sx, sy)
        jclaims = want[-1]
        accept, tile_type, idx, ops = scoring.tile3d_pass(tp, claims,
                                                          ttables, sx, sy)
        got = (accept, tile_type, idx, ops.mask, ops.mn, ops.mx, claims)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), (sx, sy)
        accepted += int(accept.sum())
    assert accepted > 0


def test_emit_tile3d_streams_matches_jax(bank):
    img = _image("img128")
    h, w = img.shape[:2]
    results = api.score_image(img, bank, "cpu")[1]
    assert set(results[0]) == {"shift", "accept", "type", "bbox", "idx",
                               "mask"}
    dtypes = {"idx": np.uint8, "mask": np.bool_, "accept": np.bool_,
              "type": np.int32, "bbox": np.uint8}
    for (sx, sy), res in zip(swizzle.TILE3D_PASS_ORDER, results):
        T, P = (h >> sy) * (w >> sx), (1 << sx) * (1 << sy)
        assert res["shift"] == (sx, sy)
        assert {k: res[k].dtype for k in dtypes} == dtypes, (sx, sy)
        assert {k: res[k].shape for k in dtypes} == {
            "idx": (T, P), "mask": (T, P), "accept": (T,), "type": (T,),
            "bbox": (T, 6)}, (sx, sy)

    def streams():
        return {"color": bytearray(), "type": [], 3: bytearray(),
                4: bytearray(), 5: bytearray(), 6: bytearray(),
                "maps": {k: np.zeros(swizzle.bitmap_size_bytes(*k, w, h) * 8,
                                     np.uint8)
                         for k in swizzle.TILE3D_PASS_ORDER}}
    got, want = streams(), streams()
    emit.emit_tile3d_streams(results, w, h, got)
    devp.emit_tile3d_streams(results, w, h, want)
    assert len(got["type"]) > 0
    for k in ("color", "type", 3, 4, 5, 6):
        assert got[k] == want[k], k
    for k in swizzle.TILE3D_PASS_ORDER:
        assert np.array_equal(got["maps"][k], want["maps"][k])


@pytest.mark.parametrize("plain", [False, True])
def test_tile3d_pass_scores_through_score48_mode(plain, bank, monkeypatch):
    """Each dense 3D pass takes its mode48 from score48_mode (its plain
    version under plain=True), one call a pass; the sums form's wrapper is
    not called. Its result equals the JAX pass's."""
    calls = []
    for name in ("score48_mode", "score48_mode_plain"):
        fn = getattr(kernels, name)
        monkeypatch.setattr(kernels, name,
                            lambda *a, fn=fn, name=name: calls.append(name)
                            or fn(*a))

    def refuse(*a):
        raise AssertionError("the sums form was called")
    monkeypatch.setattr(kernels, "score48", refuse)
    planes = _planes(_image("img64"))
    claims = torch.zeros(planes.shape, dtype=torch.bool)
    scoring.gradient_all(torch.from_numpy(planes), claims, 3)
    jp = jnp.asarray(planes)
    _, jclaims = js.gradient_all_device(jp, jnp.zeros(planes.shape, bool), 3)
    want = js.tile3d_pass_resident(jp, jclaims,
                                   *devp.bank_device_tables(bank), 3, 3)
    got = scoring.tile3d_pass(torch.from_numpy(planes), claims,
                              tables.device_tables(bank, CPU), 3, 3,
                              plain=plain)
    # on the CPU the wrapper routes to the plain version
    assert calls == (["score48_mode_plain"] if plain else
                     ["score48_mode", "score48_mode_plain"])
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("entry", ["decode_image", "encode_image",
                                   "score_image"])
def test_entry_points_default_to_the_card(entry, bank, monkeypatch):
    """Called without a device, each entry point runs on the card; with no
    card it raises and never falls back to the CPU."""
    fn = getattr(api if entry == "score_image" else yaik_tpu_torch, entry)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if entry == "decode_image":
        args = ((FIX / "img64.yaik").read_bytes(),
                (FIX / "LutFile.lut").read_bytes())
    else:
        args = (_image("img64"), bank)
    with pytest.raises(RuntimeError, match="is_available"):
        fn(*args)


@pytest.mark.parametrize("name", ["img64", "img128", "quilt128"])
def test_encode_cpu_matches_host_engine(name, bank):
    img = _image(name)
    got = yaik_tpu_torch.encode_image(img, bank, device="cpu")
    assert got == jax_encode_image(img, bank, engine="host")


def test_encode_cpu_matches_device_engine(bank):
    """== the JAX package's own device-scored encode, which runs the XLA
    scoring (and `device_pipeline`'s packing) on the CPU."""
    img = _image("img64")
    got = yaik_tpu_torch.encode_image(img, bank, device="cpu")
    assert got == jax_encode_image(img, bank, engine="device")


def test_score_then_emit_is_encode(bank):
    img = _image("img64")
    accepts, t3 = api.score_image(img, bank, "cpu")
    assert len(accepts) == 7 and len(t3) == 6
    assert api.emit_image(img, accepts, t3) == api.encode_image(img, bank,
                                                                "cpu")
    plain = api.score_image(img, bank, "cpu", plain=True)[1]
    for a, b in zip(t3, plain):
        assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("change", [
    "rgba", "enable_single_color", "enable_smooth_map", "enable_2d",
    "enable_plnt", "enable_plane_gradients"])
def test_encode_outside_the_slice_raises(change, bank):
    """RGBA and each pass the reference leaves disabled, which the port
    once refused: the port's bytes equal the JAX package's device engine's
    (2D with tests/fixtures/Bank2D, the port's loader and the JAX one)."""
    img = _image("img64")
    cfg = EncoderConfig()
    if change == "rgba":
        img = np.concatenate([img, (img[:, :, :1] // 2) | 1], axis=2)
    else:
        setattr(cfg, change, True)
    b2 = jb2d = None
    if change == "enable_2d":
        b2 = bank2d.load_bank2d(str(FIX / "Bank2D"))
        jb2d = jax_bank2d.load_bank2d(str(FIX / "Bank2D"))
    got = yaik_tpu_torch.encode_image(img, bank, device="cpu", config=cfg,
                                      bank2d=b2)
    assert got == jax_encode_image(img, bank, cfg, engine="device",
                                   bank2d=jb2d)


def test_encode_rejects_bad_images(bank):
    with pytest.raises(ValueError, match="multiples of 8"):
        yaik_tpu_torch.encode_image(np.zeros((12, 16, 3), np.uint8), bank,
                                    device="cpu")
    with pytest.raises(ValueError, match="u8"):
        yaik_tpu_torch.encode_image(np.zeros((16, 16), np.uint8), bank,
                                    device="cpu")


def test_encode_cuda_without_cuda_raises(bank, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        yaik_tpu_torch.encode_image(_image("img64"), bank, device="cuda")
