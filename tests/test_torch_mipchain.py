"""Mip chains on the port: the device engine at every level of a
box-filtered RGBA chain down to 8x8 and at sides of 8 px, where a scoring
pass has no whole tile; `decode_corpus` over mixed sizes; the counters
`score_passes_empty`, `decode_batches` and `decode_batch_streams`. The
card's half is marked `cuda` and skips without a GPU. This file imports
neither jax nor the JAX package:

    python -m pytest tests/test_torch_mipchain.py -q
    python -m pytest tests/test_torch_mipchain.py -q -m cuda --noconftest
"""
import pathlib
import sys

import numpy as np
import pytest
import torch
from PIL import Image

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import yaik_tpu_torch  # noqa: E402
from portbench.drivers.encode_mipchain import mip_down  # noqa: E402
from yaik_tpu_torch.encoder import bank as bankmod  # noqa: E402
from yaik_tpu_torch.format import swizzle  # noqa: E402
from yaik_tpu_torch.ops import kernels  # noqa: E402
from yaik_tpu_torch.parallel.batch import decode_corpus  # noqa: E402
from yaik_tpu_torch.utils import profiler  # noqa: E402

FIX = pathlib.Path(__file__).parent / "fixtures"

# (h, w) with a side of 8 px, and the 3D passes that have no whole tile
# there: the 16-px-wide (4, 3) pass where w < 16, the 16-px-high (3, 4)
# pass where h < 16
EIGHT_PX = [((8, 8), 2), ((8, 16), 1), ((16, 8), 1), ((8, 128), 1),
            ((128, 8), 1)]


def chain(top):
    """`top` and every level below it down to 8 px, each the benchmark's
    box filter of the one above."""
    out = [np.ascontiguousarray(top)]
    while out[-1].shape[0] > 8:
        out.append(mip_down(out[-1]))
    return out


def _sprite():
    return np.asarray(Image.open(FIX / "sprite256.png"))


def soft_chain():
    """64 -> 8 of sprite256's box-filtered sheet, its last 16 rows made
    transparent: MIPM and 8-bit ALPM at the top, analog alpha below."""
    top = mip_down(mip_down(_sprite()))
    top[48:] = 0
    return chain(top)


def hard_chain():
    """32 -> 8 of a crop of sprite256 with alpha cut to 0 or 255 at the
    top (1-bit ALPM there, box-filtered edges below)."""
    top = _sprite()[32:64, 32:64].copy()
    top[:, :, 3] = np.where(top[:, :, 3] >= 128, 255, 0)
    top[:, :, :3] *= (top[:, :, 3:] > 0)
    return chain(top)


def rgb_chain():
    """32 -> 8 of img64, RGB: no alpha chunk."""
    return chain(np.asarray(Image.open(FIX / "img64.png"))[:32, :32, :3])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tensors here are a few KB, and on a host
    shared by parallel test workers more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def bank3d():
    return bankmod.load_bank(str(FIX / "Bank3D"))


@pytest.fixture(scope="module")
def lut():
    return yaik_tpu_torch.assign_lut((FIX / "LutFile.lut").read_bytes())


def _empty_passes(h, w):
    return sum((h >> sy) * (w >> sx) == 0
               for sx, sy in swizzle.TILE3D_PASS_ORDER)


@pytest.fixture(scope="module")
def chain_streams(bank3d):
    """(image, the device engine's stream on the CPU) of every level of
    the three chains, in chain order."""
    out = []
    for levels in (soft_chain(), hard_chain(), rgb_chain()):
        for img in levels:
            out.append((img, yaik_tpu_torch.encode_image(img, bank3d,
                                                         device="cpu")))
    return out


# -- the CPU half ---------------------------------------------------------

def test_the_chains_hold_what_they_stand_for(chain_streams):
    from yaik_tpu_torch.decoder import reference as refdec
    tags = [[t for t, _, _ in refdec.iter_chunks(s)][:2]
            for _, s in chain_streams]
    assert tags[0] == [b"MIPM", b"ALPM"]            # the soft chain's top
    assert all(b"MIPM" not in t for t in tags[1:])
    assert all(t[0] == b"ALPM" for t in tags[1:7])  # soft and hard levels
    assert all(b"ALPM" not in t for t in tags[7:])  # the RGB chain
    assert [img.shape[0] for img, _ in chain_streams] == \
        [64, 32, 16, 8, 32, 16, 8, 32, 16, 8]


@pytest.mark.parametrize("level", range(4))
def test_device_engine_equals_host_engine_on_a_chain(bank3d, chain_streams,
                                                     level):
    img, stream = chain_streams[level]
    assert stream == yaik_tpu_torch.encode_image(img, bank3d, device="cpu",
                                                 engine="host")


@pytest.mark.parametrize("shape,empty", EIGHT_PX,
                         ids=[f"{h}x{w}" for (h, w), _ in EIGHT_PX])
def test_a_pass_with_no_whole_tile_scores_nothing(bank3d, monkeypatch,
                                                  shape, empty):
    h, w = shape
    img = np.ascontiguousarray(_sprite()[40:40 + h, 64:64 + w])
    assert _empty_passes(h, w) == empty
    calls = []
    real = kernels.score48_mode

    def counted(*a, **k):
        calls.append(a[0].shape[0])
        return real(*a, **k)
    monkeypatch.setattr(kernels, "score48_mode", counted)
    with profiler.enable() as prof:
        got = yaik_tpu_torch.encode_image(img, bank3d, device="cpu")
    assert prof.counters.get("score_passes_empty", 0) == empty
    assert len(calls) == 6 - empty and min(calls) > 0
    assert got == yaik_tpu_torch.encode_image(img, bank3d, device="cpu",
                                              engine="host")


def test_a_chain_counts_its_empty_passes(bank3d):
    with profiler.enable() as prof:
        for img in hard_chain():
            yaik_tpu_torch.encode_image(img, bank3d, device="cpu")
    assert prof.counters["score_passes_empty"] == 2     # the 8x8 level's


# size groups of the three chains: 64 (1 stream), 32, 16, 8 (3 each)
@pytest.mark.parametrize("batch_size,batches", [(8, 4), (2, 7)])
def test_decode_corpus_of_mixed_chains_equals_decode_image(
        lut, chain_streams, batch_size, batches):
    streams = [s for _, s in chain_streams]
    order = np.random.default_rng(batch_size).permutation(len(streams))
    mixed = [streams[i] for i in order]
    with profiler.enable() as prof:
        got = decode_corpus(mixed, lut, batch_size=batch_size, device="cpu")
    assert prof.counters["decode_batches"] == batches
    assert prof.counters["decode_batch_streams"] == len(streams)
    for i, s, px in zip(order, mixed, got):
        want = yaik_tpu_torch.decode_image(s, lut, device="cpu")
        np.testing.assert_array_equal(px, want)
        img = chain_streams[i][0]
        assert px.shape == img.shape


# -- the card's half --------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("level", [2, 3], ids=["16x16", "8x8"])
def test_card_encodes_small_levels_as_the_host_engine(cuda, bank3d, level):
    img = soft_chain()[level]
    h, w = img.shape[:2]
    before = kernels.score48_mode.launches, kernels.values48.launches
    with profiler.enable() as prof:
        got = yaik_tpu_torch.encode_image(img, bank3d, device=cuda)
    empty = _empty_passes(h, w)
    assert prof.counters.get("score_passes_empty", 0) == empty
    assert (kernels.score48_mode.launches - before[0],
            kernels.values48.launches - before[1]) == (6 - empty, 6 - empty)
    assert got == yaik_tpu_torch.encode_image(img, bank3d, engine="host")


@pytest.mark.cuda
def test_card_decode_corpus_of_a_chain_equals_decode_image(cuda, lut,
                                                           chain_streams):
    streams = [s for _, s in chain_streams]
    with profiler.enable() as prof:
        got = decode_corpus(streams, lut, batch_size=8, device=cuda)
    assert prof.counters["decode_batches"] == 4
    for s, px in zip(streams, got):
        np.testing.assert_array_equal(
            px, yaik_tpu_torch.decode_image(s, lut, device=cuda))
        np.testing.assert_array_equal(
            px, yaik_tpu_torch.decode_image(s, lut, engine="host"))


@pytest.mark.cuda
def test_card_skips_no_pass_on_a_2048_page(cuda, bank3d):
    page = np.ascontiguousarray(np.tile(_sprite(), (8, 8, 1)))
    with profiler.enable() as prof:
        yaik_tpu_torch.encode_image(page, bank3d, device=cuda)
    assert prof.counters.get("score_passes_empty", 0) == 0
