"""The port's split over a list of devices (`devices=`), the counterpart of
the JAX package's `mesh=`, on the CPU: `devices=["cpu"] * n` runs the
split-and-join code with the kernels' plain versions.

Every result is held against the goldens, the port's single-device call
and the JAX package's unsharded call in this process (a JAX CPU mesh is
not built here: its compiles are the nightly tests' in
tests/test_encoder_compact.py). Every comparison is exact, tolerance 0:
pixels and bytes are integers.
"""
import pathlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image

import yaik_tpu_torch
from yaik_tpu.decoder.api import assign_lut as jax_assign_lut
from yaik_tpu.encoder import bank as jbankmod
from yaik_tpu.encoder.context import encode_image as jax_encode_image
from yaik_tpu.parallel import batch as jbatch
from yaik_tpu_torch.decoder import engine
from yaik_tpu_torch.encoder import api
from yaik_tpu_torch.encoder import bank as bankmod
from yaik_tpu_torch.encoder import batch as ebatch
from yaik_tpu_torch.entry import dryrun_multichip
from yaik_tpu_torch.parallel import batch

FIX = pathlib.Path(__file__).parent / "fixtures"
CORPUS = ["img64", "img128", "img512", "img128", "img64", "img64", "img128",
          "img64"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while these tests run: the suite runs several
    workers on the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def banks():
    lut = (FIX / "LutFile.lut").read_bytes()
    return yaik_tpu_torch.assign_lut(lut), jax_assign_lut(lut)


@pytest.fixture(scope="module")
def bank3d():
    return bankmod.load_bank(str(FIX / "Bank3D"))


def _stream(name):
    return (FIX / f"{name}.yaik").read_bytes()


def _golden(name):
    return np.load(FIX / f"{name}.dec.npz")["rgb"]


def _images64(k):
    img = np.asarray(Image.open(FIX / "img64.png").convert("RGB"))
    return [np.ascontiguousarray(np.roll(img, 8 * i, axis=1))
            for i in range(k)]


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("entry", ["decode_batch", "decode_spatial",
                                   "decode_corpus"])
def test_decode_split_equals_goldens_one_device_and_jax(entry, n, banks):
    port, jax_bank = banks
    devices = ["cpu"] * n
    if entry == "decode_batch":
        names = ["img128", "quilt128"] * 2
        streams = [_stream(m) for m in names]
        got = list(batch.decode_batch(streams, port, devices=devices))
        one = list(batch.decode_batch(streams, port, device="cpu"))
        ref = list(jbatch.decode_batch(streams, jax_bank))
    elif entry == "decode_spatial":
        names = ["img128"]
        got = [batch.decode_spatial(_stream("img128"), port,
                                    devices=devices)]
        one = [batch.decode_spatial(_stream("img128"), port, device="cpu",
                                    n_bands=n)]
        ref = [jbatch.decode_spatial(_stream("img128"), jax_bank,
                                     n_bands=n)]
    else:
        names = CORPUS
        streams = [_stream(m) for m in names]
        got = batch.decode_corpus(streams, port, batch_size=n,
                                  devices=devices)
        one = batch.decode_corpus(streams, port, batch_size=n, device="cpu")
        ref = jbatch.decode_corpus(streams, jax_bank, batch_size=n,
                                   planner_workers=1)
    assert len(got) == len(names)
    for g, o, r, m in zip(got, one, ref, names):
        assert g.dtype == np.uint8
        assert np.array_equal(g, _golden(m))
        assert np.array_equal(g, o)
        assert np.array_equal(g, r)


@pytest.fixture(scope="module")
def enc64(bank3d):
    """Four 64x64 images, the port's unsplit `encode_corpus` of them and
    the JAX package's `encode_image(engine="device")` of each."""
    imgs = _images64(4)
    jbank = jbankmod.load_bank(str(FIX / "Bank3D"))
    return (imgs, ebatch.encode_corpus(imgs, bank3d, batch_size=4,
                                       device="cpu"),
            [jax_encode_image(im, jbank, engine="device") for im in imgs])


@pytest.mark.parametrize("entry", ["encode_batch", "encode_corpus"])
def test_encode_split_equals_one_device_and_jax(entry, bank3d, enc64):
    imgs, one, ref = enc64
    kw = {} if entry == "encode_batch" else {"batch_size": 4}
    got = getattr(ebatch, entry)(imgs, bank3d, devices=["cpu"] * 2, **kw)
    assert got == one
    assert got == ref


def test_encode_corpus_short_batch_and_shapes(bank3d, enc64):
    """A corpus whose last 64x64 batch is short (3 = 2 + 1 over 2 devices)
    beside a 48x64 group of one: each stream equals encode_image's."""
    imgs, one, _ = enc64
    crop = np.ascontiguousarray(imgs[1][:48])
    got = ebatch.encode_corpus([imgs[0], crop, imgs[1], imgs[2]], bank3d,
                               batch_size=2, devices=["cpu"] * 2)
    assert got == [one[0], api.encode_image(crop, bank3d, device="cpu"),
                   one[1], one[2]]


@pytest.mark.parametrize("n,rows", [(4, 96), (2, 64)])
def test_encode_image_banded_mesh_equals_encode_image(n, rows, bank3d):
    """96 rows over 4 devices: bands of 32, so band 3 is all pad (its
    grids are cut away) and band 2's halo is the repeated bottom row, as
    in the JAX package's test of its mesh; 64 rows over 2 devices: bands
    of 32, the last halo a repeated row."""
    img = np.asarray(Image.open(FIX / "img128.png").convert("RGB"))
    img = np.ascontiguousarray(img[:rows, :64])
    got = ebatch.encode_image_banded_mesh(img, bank3d, devices=["cpu"] * n)
    assert got == api.encode_image(img, bank3d, device="cpu")


@pytest.mark.parametrize("case", [
    "decode_batch size", "decode_spatial bands", "decode_spatial count",
    "decode_corpus batch_size", "encode_batch size",
    "encode_corpus batch_size", "banded_mesh h % 16", "banded_mesh h % 8",
    "decode device and devices", "encode device and devices",
    "empty devices"])
def test_refused_splits_raise_value_error(case, banks, bank3d):
    port = banks[0]
    img64 = _images64(1)[0]
    two = ["cpu"] * 2
    calls = {
        "decode_batch size": (lambda: batch.decode_batch(
            [_stream("img64")] * 3, port, devices=two), "equal slices"),
        "decode_spatial bands": (lambda: batch.decode_spatial(
            _stream("img512"), port, devices=["cpu"] * 3), "equal bands"),
        "decode_spatial count": (lambda: batch.decode_spatial(
            _stream("img128"), port, n_bands=2, devices=["cpu"] * 4),
            "equal slices"),
        "decode_corpus batch_size": (lambda: batch.decode_corpus(
            [_stream("img64")], port, batch_size=3, devices=two),
            "multiple of"),
        "encode_batch size": (lambda: ebatch.encode_batch(
            [img64] * 3, bank3d, devices=two), "must divide"),
        "encode_corpus batch_size": (lambda: ebatch.encode_corpus(
            [img64], bank3d, batch_size=3, devices=two), "multiple of"),
        "banded_mesh h % 16": (lambda: ebatch.encode_image_banded_mesh(
            img64[:56], bank3d, devices=two), "height % 16"),
        "banded_mesh h % 8": (lambda: ebatch.encode_image_banded_mesh(
            img64[:60], bank3d, devices=two), "multiples of 8"),
        "decode device and devices": (lambda: batch.decode_batch(
            [_stream("img64")] * 2, port, device="cpu", devices=two),
            "not both"),
        "encode device and devices": (lambda: ebatch.encode_corpus(
            [img64] * 2, bank3d, device="cuda", devices=two), "not both"),
        "empty devices": (lambda: batch.decode_corpus(
            [_stream("img64")], port, devices=[]), "no device"),
    }
    fn, match = calls[case]
    with pytest.raises(ValueError, match=match):
        fn()


@pytest.mark.parametrize("call", ["data_devices", "decode_batch",
                                  "encode_corpus", "banded_mesh default"])
def test_no_card_raises_and_never_uses_the_cpu(call, banks, bank3d,
                                               monkeypatch):
    """Cards asked for where there is none raise: `data_devices` lists no
    CPU in their place, and "cuda" in `devices=` raises as `device=`
    does."""
    _no_card(monkeypatch)
    img64 = _images64(1)[0]
    fn = {"data_devices": lambda: batch.data_devices(2),
          "decode_batch": lambda: batch.decode_batch(
              [_stream("img64")] * 2, banks[0], devices=["cuda"] * 2),
          "encode_corpus": lambda: ebatch.encode_corpus(
              [img64] * 2, bank3d, batch_size=2, devices=["cuda:0"] * 2),
          "banded_mesh default": lambda: ebatch.encode_image_banded_mesh(
              img64, bank3d)}[call]
    with pytest.raises(RuntimeError):
        fn()


def test_data_devices_lists_distinct_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert batch.data_devices() == [torch.device("cuda", i)
                                    for i in range(3)]
    assert batch.data_devices(2) == [torch.device("cuda", 0),
                                     torch.device("cuda", 1)]
    for n in (0, 4):
        with pytest.raises(RuntimeError, match="3 CUDA devices"):
            batch.data_devices(n)


@pytest.mark.parametrize("k,n,sizes", [(8, 4, [2, 2, 2, 2]),
                                       (3, 4, [1, 1, 1]),
                                       (7, 3, [3, 2, 2]),
                                       (0, 2, [])])
def test_split_keeps_order_in_near_equal_slices(k, n, sizes):
    slices = batch.split(list(range(k)), n)
    assert [len(s) for s in slices] == sizes
    assert sum(slices, []) == list(range(k))


def test_devices_of_and_the_default_device():
    assert engine.CARD == "cuda"
    assert engine.devices_of("cpu", None) == [torch.device("cpu")]
    assert engine.devices_of(engine.CARD, ["cpu", torch.device("cpu")]) \
        == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="not both"):
        engine.devices_of("cuda", ["cpu"])


def test_a_thread_a_slice_gives_the_same_results(banks, bank3d,
                                                  monkeypatch):
    """chip_smoke.py times the slices dispatched from a thread each (in
    `over_slices`' place): the shared device tables and the slices' work
    give the same pixels and bytes from threads."""
    def thread_a_slice(fn, jobs):
        with ThreadPoolExecutor(len(jobs)) as pool:
            return list(pool.map(lambda job: fn(*job), jobs))

    port = banks[0]
    streams = [_stream("img128"), _stream("quilt128")] * 2
    imgs = _images64(2)
    one = batch.decode_batch(streams, port, device="cpu")
    enc = ebatch.encode_batch(imgs, bank3d, device="cpu")
    monkeypatch.setattr(batch, "over_slices", thread_a_slice)
    assert np.array_equal(batch.decode_batch(streams, port,
                                             devices=["cpu"] * 4), one)
    assert ebatch.encode_batch(imgs, bank3d, devices=["cpu"] * 2) == enc


def test_device_tables_build_once_under_threads():
    """Threads sharing a `DeviceTables` (the slices' threads, emission
    threads) build each (bank, device) entry once and all get it."""
    import sys
    import time
    from yaik_tpu_torch.decoder.api import DeviceTables

    builds = []

    def build(bank, device):
        builds.append(device)
        time.sleep(0.001)            # widen the check-then-act window
        return object()

    class Bank:
        pass

    tables, bank = DeviceTables(build), Bank()
    devs = [torch.device("cpu"), torch.device("meta")]
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(32) as pool:
            got = list(pool.map(lambda k: tables.get(bank, devs[k % 2]),
                                range(256)))
    finally:
        sys.setswitchinterval(before)
    assert sorted(map(str, builds)) == ["cpu", "meta"]
    assert {id(g) for g in got[0::2]} == {id(got[0])}
    assert {id(g) for g in got[1::2]} == {id(got[1])}


def test_dryrun_multichip_over_two_cpu_slices(capsys):
    """All seven axes of the JAX package's dryrun, in this process; on the
    CPU no kernel launches, so every axis counts none."""
    per_axis = dryrun_multichip(2, devices=["cpu"] * 2)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 7 and all(" OK, " in ln for ln in lines)
    assert list(per_axis) == ["DP", "spatial", "RGBA", "2DTL", "corpus",
                              "encode-scoring DP", "spatial encode"]
    assert all(v == {} for v in per_axis.values())

