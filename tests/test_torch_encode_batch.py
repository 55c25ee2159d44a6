"""The port's batched, compacted encode (yaik_tpu_torch.encoder.batch)
against the JAX package on the CPU, at 64x64 and 128x128 with B = 2.

Each device stage against its JAX counterpart on the same operands: the
batched gradient stage against `jax_scoring.gradient_all_device` image by
image, the batched 3D pass against `tile3d_pass_resident_b` (dense, and
with a scoring cap above and below the images' alive-tile counts), the
compact blob against `device_pipeline._compact_pass` on the same packed
rows. Then whole streams: `encode_batch`, `encode_corpus` and
`encode_image_banded` against the port's `encode_image` and the JAX
package's host engine, run in this process (same zstd). Every comparison
is exact, tolerance 0: the arithmetic is integer.

On the CPU the scoring kernels run their plain versions;
tests/test_torch_cuda.py runs `encode_batch` on the card.
"""
import inspect
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from yaik_tpu.encoder import bank as bankmod
from yaik_tpu.encoder import device_pipeline as devp
from yaik_tpu.encoder import jax_scoring as js
from yaik_tpu.encoder.context import EncoderConfig
from yaik_tpu.encoder.context import encode_image as jax_encode_image
from yaik_tpu.format import swizzle
from yaik_tpu_torch.encoder import api, batch, pipeline, scoring, tables

FIX = pathlib.Path(__file__).parent / "fixtures"
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def bank():
    return bankmod.load_bank(str(FIX / "Bank3D"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while these tests run: the suite runs several
    workers on the host's cores, and torch's default of one thread per
    core each oversubscribes them many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cap_state():
    """A clean learned-caps table for the test, restored after it."""
    saved = dict(batch._CAP_STATE)
    batch._CAP_STATE.clear()
    yield batch._CAP_STATE
    batch._CAP_STATE.clear()
    batch._CAP_STATE.update(saved)


def _image(name):
    return np.asarray(Image.open(FIX / f"{name}.png"))


def _variant(img, i):
    """A distinct image of the same size: rolled by multiples of 8 (tile
    alignment kept) and flipped."""
    v = np.roll(np.roll(img, 8 * (i + 1), axis=1), 8 * (2 * i + 1), axis=0)
    return np.ascontiguousarray(v[::-1] if i % 2 else v[:, ::-1])


def _pair(size):
    return ([_image("img64"), _variant(_image("img64"), 0)] if size == 64
            else [_image("img128"), _image("quilt128")])


def _planes(imgs):
    return np.stack([im.transpose(2, 0, 1) for im in imgs]).astype(np.int32)


def _noise(size, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (size, size, 3),
                                                np.uint8)


# the JAX package's _compact_pass, jitted as its callers jit it
_jax_compact = jax.jit(devp._compact_pass, static_argnums=2)
_PORT: dict = {}
_CHECKED: set = set()


def _port(img, bank):
    """The port's encode_image of an image, computed once."""
    key = (img.shape, img.tobytes())
    if key not in _PORT:
        _PORT[key] = api.encode_image(img, bank, "cpu")
    return _PORT[key]


def _want(img, bank):
    """The port's encode_image, after checking that it equals the JAX
    package's host engine in this process (once per image)."""
    got = _port(img, bank)
    key = (img.shape, img.tobytes())
    if key not in _CHECKED:
        assert got == jax_encode_image(img, bank, engine="host")
        _CHECKED.add(key)
    return got


@pytest.mark.parametrize("size", [64, 128])
def test_gradient_batch_matches_jax(size):
    """One batched call: each image's 7 accept grids and its claims equal
    `gradient_all_device` of that image alone."""
    planes = _planes(_pair(size))
    claims = torch.zeros(planes.shape, dtype=torch.bool)
    got = scoring.gradient_all(torch.from_numpy(planes), claims, 3)
    assert [tuple(a.shape) for a in got] == [
        (2, size >> sy, size >> sx) for (sx, sy) in swizzle.GRADIENT_PASS_ORDER]
    for i in range(2):
        want, jclaims = js.gradient_all_device(
            jnp.asarray(planes[i]), jnp.zeros(planes[i].shape, bool), 3)
        for g, w in zip(got, want):
            assert np.array_equal(g[i].numpy(), np.asarray(w))
        assert np.array_equal(claims[i].numpy(), np.asarray(jclaims))
    assert any(a.any() for a in got)


def _claims_before_4x4(planes, ttables):
    """The claims a batch holds when its 4x4 pass starts: the gradient
    stage's, then the first five 3D passes'."""
    tp = torch.from_numpy(planes)
    claims = torch.zeros(planes.shape, dtype=torch.bool)
    scoring.gradient_all(tp, claims, 3)
    for (sx, sy) in swizzle.TILE3D_PASS_ORDER[:-1]:
        scoring.tile3d_pass_b(tp, claims, ttables, sx, sy)
    return claims


@pytest.mark.parametrize("cap", [None, "above", "below"])
def test_tile3d_pass_b_matches_jax(cap, bank):
    """The 4x4 pass over a batch of two 64x64 images, dense and with a
    scoring cap above both images' alive-tile counts and below them: every
    output equals `tile3d_pass_resident_b`'s with the same cap, claims
    and alive_cnt included."""
    planes = _planes(_pair(64))
    ttables = tables.device_tables(bank, CPU)
    claims = _claims_before_4x4(planes, ttables)
    live = (~claims.all(1)).reshape(2, 16, 4, 16, 4).any(4).any(2)
    counts = live.reshape(2, -1).sum(1).tolist()
    assert min(counts) > 8 and counts[0] != counts[1]
    cap_score = {None: None, "above": max(counts) + 5,
                 "below": min(counts) - 7}[cap]
    want = js.tile3d_pass_resident_b(
        jnp.asarray(planes), jnp.asarray(claims.numpy()),
        *devp.bank_device_tables(bank), 2, 2, cap_score=cap_score)
    got = scoring.tile3d_pass_b(torch.from_numpy(planes), claims, ttables,
                                2, 2, cap_score=cap_score)
    names = ("accept", "tile_type", "idx", "mask", "mn", "mx", "claims",
             "alive_cnt")
    for name, g, w in zip(names, (*got[:6], claims, got.alive_cnt), want):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    assert got.alive_cnt.tolist() == ([0, 0] if cap is None else counts)
    if cap == "below":      # the tiles past the cap were left unscored
        assert int(got.accept.sum()) < int(
            scoring.tile3d_pass_b(torch.from_numpy(planes),
                                  _claims_before_4x4(planes, ttables),
                                  ttables, 2, 2).accept.sum())


def test_packed_pass_unpacks_to_the_pass(bank):
    """`_resident_packed`'s rows hold the pass's results, as the JAX
    package's `_unpack_pass` reads them."""
    planes = torch.from_numpy(_planes(_pair(64)))
    ttables = tables.device_tables(bank, CPU)
    c1 = torch.zeros(planes.shape, dtype=torch.bool)
    c2 = torch.zeros(planes.shape, dtype=torch.bool)
    scoring.gradient_all(planes, c1, 3)
    scoring.gradient_all(planes, c2, 3)
    packed, alive_cnt = pipeline._resident_packed(planes, c1, ttables, 3, 3)
    r = scoring.tile3d_pass_b(planes, c2, ttables, 3, 3)
    assert packed.dtype == torch.uint8 and packed.shape == (2, 64, 64 + 9)
    for i in range(2):
        idx, mask, accept, typ, bbox = devp._unpack_pass(packed[i].numpy(),
                                                         64)
        assert np.array_equal(idx, r.idx[i].numpy() & 63)
        assert np.array_equal(mask, r.mask[i].numpy())
        assert np.array_equal(accept, r.accept[i].numpy())
        assert np.array_equal(typ, r.tile_type[i].numpy())
        assert np.array_equal(bbox, torch.cat([r.mn[i], r.mx[i]], 1).numpy()
                              .astype(np.uint8))
    assert torch.equal(c1, c2) and alive_cnt.tolist() == [0, 0]


def test_compact_pass_matches_jax(bank):
    """On the same packed rows, the port's `_compact_pass` blob equals
    `device_pipeline._compact_pass`'s byte for byte, with the download
    cap below and above the accepted counts (rows past the count are the
    clamped gather of the last scan tile, as there)."""
    size = 64
    planes = torch.from_numpy(_planes(_pair(size)))
    ttables = tables.device_tables(bank, CPU)
    claims = torch.zeros(planes.shape, dtype=torch.bool)
    scoring.gradient_all(planes, claims, 3)
    checked = 0
    for (sx, sy) in swizzle.TILE3D_PASS_ORDER:
        packed, alive_cnt = pipeline._resident_packed(
            planes, claims, ttables, sx, sy, cap_score=64)
        _, gids = devp._scan_perm(sx, sy, size, size)
        counts = packed[:, :, -9].sum(1).tolist()
        for cap in {max(1, min(counts)), max(counts) + 3, len(gids)}:
            got = pipeline._compact_pass(packed, torch.from_numpy(
                gids.astype(np.int64)), cap, alive_cnt)
            want = _jax_compact(jnp.asarray(packed.numpy()),
                                jnp.asarray(gids), cap,
                                jnp.asarray(alive_cnt.numpy()))
            assert np.array_equal(got.numpy(), np.asarray(want)), (sx, sy)
            checked += 1
    assert checked >= 12



def test_tile3d_all_compact_is_the_passes_compacted(bank):
    """`_tile3d_all_compact` lays the six passes out as the JAX package
    does: each `_compact_pass` (JAX's) of the pass scored with its caps,
    claims evolving; `unpack_compact` reads it as the JAX package's."""
    planes = torch.from_numpy(_planes(_pair(128)))
    ttables = tables.device_tables(bank, CPU)
    caps = pipeline.pass_caps(128, 128)
    c1 = torch.zeros(planes.shape, dtype=torch.bool)
    scoring.gradient_all(planes, c1, 3)
    c2 = c1.clone()
    got = pipeline._tile3d_all_compact(planes, c1, ttables,
                                       pipeline.scan_perms(128, 128, CPU),
                                       caps)
    parts = []
    for (sx, sy), (scap, dcap) in zip(swizzle.TILE3D_PASS_ORDER, caps):
        packed, alive_cnt = pipeline._resident_packed(planes, c2, ttables,
                                                      sx, sy, scap)
        parts.append(np.asarray(_jax_compact(
            jnp.asarray(packed.numpy()),
            jnp.asarray(devp._scan_perm(sx, sy, 128, 128)[1]), dcap,
            jnp.asarray(alive_cnt.numpy()))))
    assert np.array_equal(got.numpy(), np.concatenate(parts, axis=1))
    assert torch.equal(c1, c2)
    mine = pipeline.unpack_compact(got.numpy(), 128, 128, caps)
    theirs = devp.unpack_compact(got.numpy(), 128, 128, caps)
    for a, b in zip(mine, theirs):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k


def test_encode_batch_matches_encode_image(bank):
    imgs = _pair(64)
    got = batch.encode_batch(imgs, bank, device="cpu")
    assert got == [_want(im, bank) for im in imgs]


def test_encode_batch_threads_and_overflow(bank, cap_state, monkeypatch):
    """A noise image overflows the default caps: they grow, and the batch
    is scored again as a batch; its images emit on two threads, each with
    its own zstd batch. Every stream is unchanged."""
    dispatched = []
    real = batch._dispatch_batch
    monkeypatch.setattr(batch, "_dispatch_batch",
                        lambda *a: dispatched.append(a[4]) or real(*a))
    imgs = [_image("img64"), _noise(64), _variant(_image("img64"), 1)]
    got = batch.encode_batch(imgs, bank, device="cpu", emit_workers=2)
    assert got == [_want(im, bank) for im in imgs]
    assert dispatched == [pipeline.pass_caps(64, 64),
                          cap_state[(64, 64, 3)]]


def test_caps_of_every_tile_never_grow(bank, cap_state, monkeypatch):
    """cap_frac = dcap_frac = 1 scores and downloads every tile: the noise
    image fits, and the batch is scored once."""
    dispatched = []
    real = batch._dispatch_batch
    monkeypatch.setattr(batch, "_dispatch_batch",
                        lambda *a: dispatched.append(a[4]) or real(*a))
    imgs = [_noise(64), _image("img64")]
    got = batch.encode_batch(imgs, bank, device="cpu", cap_frac=1,
                             dcap_frac=1)
    assert got == [_want(im, bank) for im in imgs]
    assert dispatched == [pipeline.pass_caps(64, 64, 1, 1)]
    assert all(s == d == (64 >> sy) * (64 >> sx) for (s, d), (sx, sy)
               in zip(dispatched[0], swizzle.TILE3D_PASS_ORDER))
    assert not cap_state


def test_encode_corpus_mixed_shapes(bank, cap_state):
    """Two shapes in a shuffled order, batch_size 2: the 64x64 group of
    three ends in a short batch; the noise image makes its batch's caps
    grow. Streams come back in input order."""
    imgs = [_image("img64"), _image("img128"), _noise(64),
            _image("quilt128"), _variant(_image("img64"), 1)]
    got = batch.encode_corpus(imgs, bank, batch_size=2, device="cpu")
    assert got == [_want(im, bank) for im in imgs]
    assert (64, 64, 3) in cap_state


def test_encode_corpus_tiny_caps_grow_and_are_reused(bank, cap_state,
                                                     monkeypatch):
    """Caps of one tile overflow every pass: the batch is scored again
    with grown caps (`caps_fit`), learned per shape; a second corpus of
    that shape starts from them and is scored once per batch."""
    monkeypatch.setattr(pipeline, "pass_caps",
                        lambda w, h, *a, **k: ((1, 1),) * 6)
    dispatched = []
    real = batch._dispatch_batch
    monkeypatch.setattr(batch, "_dispatch_batch",
                        lambda *a: dispatched.append(a[4]) or real(*a))
    imgs = _pair(64)
    want = [_want(im, bank) for im in imgs]
    assert batch.encode_corpus(imgs, bank, batch_size=2,
                               device="cpu") == want
    learned = cap_state[(64, 64, 3)]
    assert len(dispatched) >= 2 and dispatched[0] == ((1, 1),) * 6
    assert any(s > 1 or d > 1 for s, d in learned)
    dispatched.clear()
    assert batch.encode_corpus(imgs[::-1], bank, batch_size=2,
                               device="cpu") == want[::-1]
    assert dispatched == [learned]


@pytest.mark.parametrize("workers", [0, 2])
def test_encode_corpus_emission_threads(workers, bank, cap_state):
    """Five images in batches of two (2, 2, 1), emitted on the calling
    thread or on two threads: the same streams."""
    imgs = [_variant(_image("img64"), i) for i in range(5)]
    got = batch.encode_corpus(imgs, bank, batch_size=2, device="cpu",
                              emit_workers=workers)
    assert got == [_port(im, bank) for im in imgs]


@pytest.mark.parametrize("band", [48, None])
def test_encode_image_banded(band, bank):
    """Bands of 48 rows with a one-row halo, 48 + 48 + 32 of 128; one band
    by default."""
    img = _image("img128")
    got = batch.encode_image_banded(img, bank, device="cpu", band_rows=band)
    assert got == _want(img, bank)


def test_encode_image_banded_remainder(bank):
    """56 rows in bands of 16: 16 + 16 + 24, the sub-16 remainder joined
    to the last band. The JAX host engine takes no height that is not a
    multiple of 16, so its device engine (XLA on the CPU) is the reference
    here."""
    img = np.ascontiguousarray(_image("img64")[:56])
    got = batch.encode_image_banded(img, bank, device="cpu", band_rows=16)
    assert got == _port(img, bank)
    assert got == jax_encode_image(img, bank, engine="device")


def test_the_ceiling_bands_images_and_splits_batches(bank, monkeypatch):
    """Past `max_pix` pixels an image is banded, through both batch entry
    points; a batch over it is scored in parts."""
    img = _image("img64")
    want = _want(img, bank)
    bands = []
    real = batch.encode_image_banded

    def spy(*a, **k):
        bands.append(k["max_pix"])
        return real(*a, **k)
    monkeypatch.setattr(batch, "encode_image_banded", spy)
    assert batch.encode_batch([img], bank, device="cpu",
                              max_pix=64 * 32) == [want]
    assert batch.encode_corpus([img], bank, device="cpu",
                               max_pix=64 * 32) == [want]
    assert bands == [64 * 32] * 2 and batch._band_rows(64, 64,
                                                       64 * 32) == 32
    imgs = _pair(64)
    assert batch.encode_batch(imgs, bank, device="cpu",
                              max_pix=64 * 64) == [_want(im, bank)
                                                   for im in imgs]


@pytest.mark.parametrize("entry", ["encode_batch", "encode_corpus",
                                   "encode_image_banded"])
def test_entry_points_default_to_the_card(entry, bank, monkeypatch):
    fn = getattr(batch, entry)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = _image("img64")
    with pytest.raises(RuntimeError, match="is_available"):
        fn(img if entry == "encode_image_banded" else [img], bank)


@pytest.mark.parametrize("change", ["rgba", "enable_2d"])
@pytest.mark.parametrize("entry", ["encode_batch", "encode_corpus"])
def test_outside_the_slice_raises(entry, change, bank):
    """What the batch entry points once refused: an RGBA image now encodes
    to the JAX package's device engine's bytes; `enable_2d` raises the JAX
    package's ValueError, since they take no 2D bank (the JAX package's
    batch engine takes none either)."""
    img = _image("img64")
    cfg = EncoderConfig()
    if change == "rgba":
        img = np.concatenate([img, 255 - img[:, :, 1:2]], 2)
        got = getattr(batch, entry)([img], bank, cfg, device="cpu")
        assert got == [jax_encode_image(img, bank, cfg, engine="device")]
    else:
        cfg.enable_2d = True
        with pytest.raises(ValueError, match="enable_2d requires a bank2d"):
            getattr(batch, entry)([img], bank, cfg, device="cpu")


def test_bad_batches_raise(bank):
    with pytest.raises(ValueError, match="same-shaped"):
        batch.encode_batch([_image("img64"), _image("img128")], bank,
                           device="cpu")
    with pytest.raises(ValueError, match="multiple of 16"):
        batch.encode_image_banded(_image("img128"), bank, device="cpu",
                                  band_rows=40)
