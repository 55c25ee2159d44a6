"""The port's LUT-bank miner (yaik_tpu_torch.encoder.mining) and its
coverage kernels' plain versions (`kernels.covers`, `kernels.covers2d`)
against the JAX package on the CPU.

The coverage matrices against `mining._covers_device` /
`_covers2d_device` (XLA) and the numpy `_covers` / `_covers_2d` loops, bit
for bit, through the wrappers (which take the plain route on CPU tensors)
and through the plain versions with their chunks forced small so that
every chunk edge is crossed; then `mine_bank` (with its checkpoint) and
`mine_bank2d` output files against the JAX package's `engine="device"`
files, byte for byte. The arithmetic is integer, so every comparison is exact.
The 2D plain version also meets `_covers2d_device` on tests/torch_covers.py's
edge operands, and the 2D kernel's batch plan (`kernels.covers2d_plan`) is
held to its definition and, through a numpy model of the kernel's walk over
its batches, to the plain version.

tests/test_torch_cuda.py holds the CUDA kernel to the plain versions on
the card.
"""
import inspect
import os
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image

import torch_covers
from yaik_tpu.encoder import mining as jmining
from yaik_tpu_torch.encoder import mining
from yaik_tpu_torch.ops import kernels

FIX = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rgb(name):
    return np.asarray(Image.open(FIX / f"{name}.png"))[:, :, :3]


def _clouds3d(rng, k, n):
    """k candidate clouds and n tiles near them (so some are covered)."""
    cands = rng.integers(0, 64, (k, 64, 3)).astype(np.uint8)
    near = cands[rng.integers(0, k, n)].astype(np.int32)
    tiles = np.clip(near + rng.integers(-6, 7, (n, 64, 3)), 0, 63)
    return cands, tiles.astype(np.uint8)


@pytest.mark.parametrize("k,n,chunk", [(13, 37, (3, 5)), (8, 64, (8, 64)),
                                       (1, 1, (1, 1))])
def test_covers_equals_the_jax_package(k, n, chunk):
    rng = np.random.default_rng(k * 100 + n)
    cands, tiles = _clouds3d(rng, k, n)
    want = jmining._covers_device(cands, tiles, 75)
    assert np.array_equal(want, np.stack([jmining._covers(c, tiles, 75)
                                          for c in cands]))
    for dt in (torch.uint8, torch.int32):
        ops = (torch.from_numpy(cands).to(dt), torch.from_numpy(tiles).to(dt))
        got = kernels.covers(*ops, 75)
        assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
        assert np.array_equal(kernels.covers_plain(*ops, 75, chunk).numpy(),
                              want)
    if k == 13:
        assert 0 < want.sum() < want.size


def _sets2d(rng, m):
    """m deduplicated point sets of 1..64 points in the 64x64 plane."""
    out = []
    for _ in range(m):
        pts = rng.integers(0, 64, (int(rng.integers(1, 65)), 2))
        out.append(np.unique(pts, axis=0)[:64].astype(np.uint8))
    return out


@pytest.mark.parametrize("m,chunk", [(29, (2, 7)), (40, (8, 2048))])
def test_covers2d_equals_the_jax_package(m, chunk):
    rng = np.random.default_rng(m)
    clouds = _sets2d(rng, m)
    cands = clouds[::3]
    want = jmining._covers2d_device(cands, clouds)
    assert np.array_equal(want, np.stack([jmining._covers_2d(c, clouds)
                                          for c in cands]))
    ops = (*mining._padded(cands), *mining._padded(clouds))
    ops = [torch.from_numpy(a) for a in ops]
    assert np.array_equal(kernels.covers2d(*ops).numpy(), want)
    assert np.array_equal(kernels.covers2d_plain(*ops, chunk=chunk).numpy(),
                          want)
    assert 0 < want.sum() < want.size


@pytest.mark.parametrize("case,gate", [
    *((case, 36) for case in torch_covers.CASES),
    *(("seeded", gate) for gate in torch_covers.GATES[1:]),
    ("wide", 2 ** 20)])
def test_covers2d_edges_equal_the_jax_package(case, gate):
    """Empty and full candidates and tiles, tiles of 0..2 pixels,
    interleaved live and pad slots (the JAX package takes their sets),
    i32 coordinates up to 4096, and every gate of tests/torch_covers.py."""
    ops = torch_covers.operands(case, 11, 41, 5)
    want = jmining._covers2d_device(torch_covers.sets_of(*ops[:2]),
                                    torch_covers.sets_of(*ops[2:]), gate)
    got = kernels.covers2d(*(torch.from_numpy(a) for a in ops), gate=gate)
    assert np.array_equal(got.numpy(), want)
    if case == "seeded" and gate == 36:
        assert 0 < want.sum() < want.size


@pytest.mark.parametrize("case", torch_covers.CASES)
@pytest.mark.parametrize("cap", [64, 512])
def test_covers2d_plan(case, cap):
    """Each tile's start in the stream of counted pixels, and each batch's
    first tile."""
    tmask = torch_covers.operands(case, 1, 300, 3)[3]
    if case == "empty_tiles":
        tmask[-5:] = False                     # empty tiles at the end too
    starts = np.concatenate([[0], np.cumsum(tmask.sum(1))])
    nb = 300 * 64 // cap + 1
    st, tf = kernels.covers2d_plan(torch.from_numpy(tmask), cap)
    assert st.dtype == tf.dtype == torch.int32
    assert np.array_equal(st.numpy(), starts)
    assert np.array_equal(tf.numpy(), np.searchsorted(
        starts[:-1], np.arange(nb + 1) * cap, side="left"))
    with pytest.raises(ValueError, match="cap"):
        kernels.covers2d_plan(torch.from_numpy(tmask), 63)


def _kernel_walk(cands, cmask, tiles, tmask, gate, cap):
    """csrc/covers.cu's 2D walk in numpy over covers2d_plan's batches:
    batch b takes the slots [b * cap, (b + 1) * cap) of the stream of
    counted pixels, the tiles that start there and the one that runs in,
    a slot's pixel found by its rank among its tile's counted pixels; a
    tile crossing a batch edge is counted in two parts that meet in a
    counter. Each entry must be written exactly once."""
    starts, tfirst = (x.numpy().astype(np.int64) for x in
                      kernels.covers2d_plan(torch.from_numpy(tmask), cap))
    k, n = len(cands), len(tiles)
    total, nb = starts[n], len(tfirst) - 1
    out = np.zeros((k, n), bool)
    writes = np.zeros((k, n), int)
    counter = np.zeros((k, nb), np.int64)
    for b in range(nb):
        lo = b * cap
        if lo > total:
            break
        hi = min(lo + cap, total)
        ta, tz = tfirst[b], tfirst[b + 1]
        if ta > 0 and starts[ta] > lo:
            ta -= 1
        px = np.zeros((cap, 2), np.int64)
        for t in range(ta, tz):
            ranks = np.flatnonzero(tmask[t])
            for s in range(max(starts[t], lo), min(starts[t + 1], hi)):
                px[s - lo] = tiles[t, ranks[s - starts[t]]]
        for c in range(k):
            live = cands[c][cmask[c]].astype(np.int64)
            d = (((px[:, None] - live[None]) ** 2).sum(-1).min(-1)
                 if len(live) else np.full(cap, np.inf))
            viol = d > gate
            if len(live) < 64:              # the pad point beside them
                viol &= ((4096 - px) ** 2).sum(-1) > gate
            for t in range(ta, tz):
                st, en = starts[t], starts[t + 1]
                cnt = int(viol[max(st, lo) - lo:min(en, hi) - lo].sum())
                if st < lo or en > hi:
                    edge = b - 1 if st < lo else b
                    old = counter[c, edge]
                    counter[c, edge] += cnt + 1024
                    if old < 1024:
                        continue
                    cnt += old - 1024
                out[c, t] = cnt <= 3
                writes[c, t] += 1
    assert (writes == 1).all()
    return out


@pytest.mark.parametrize("case", torch_covers.CASES)
def test_kernel_walk_equals_plain(case):
    """The batch walk the 2D kernel does over covers2d_plan's batches
    gives the plain version's matrix, for batches of 64, 96 and the
    kernel's 512 pixels and every gate."""
    ops = torch_covers.operands(case, 3, 300, 9)
    for gate in torch_covers.GATES:
        want = kernels.covers2d_plain(*(torch.from_numpy(a) for a in ops),
                                      gate=gate).numpy()
        for cap in (64, 96, kernels.COVERS2D_CAP):
            assert np.array_equal(_kernel_walk(*ops, gate, cap), want)


def test_covers_refuses_bad_operands():
    c = torch.zeros((2, 64, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="64, 3"):
        kernels.covers(c, torch.zeros((5, 63, 3), dtype=torch.uint8))
    with pytest.raises(TypeError, match="int64"):
        kernels.covers(c, torch.zeros((5, 64, 3), dtype=torch.int64))
    with pytest.raises(ValueError, match="64, 2"):
        kernels.covers2d(c, torch.ones((2, 64), dtype=torch.bool),
                         torch.zeros((5, 64, 2), dtype=torch.uint8),
                         torch.ones((5, 64), dtype=torch.bool))
    c2 = torch.zeros((2, 64, 2), dtype=torch.uint8)
    with pytest.raises(TypeError, match="bool"):
        kernels.covers2d(c2, torch.ones((2, 64), dtype=torch.uint8), c2,
                         torch.ones((2, 64), dtype=torch.bool))
    m2 = torch.ones((2, 64), dtype=torch.bool)
    for gate in (2 ** 31, -2 ** 31 - 1):
        with pytest.raises(ValueError, match="int32"):
            kernels.covers2d(c2, m2, c2, m2, gate)
    assert kernels.covers2d(c2, m2, c2, m2, 2 ** 31 - 1).all()


def test_capture_clouds_equal_the_jax_package():
    """The device gradient scoring's claims give the JAX package's clouds
    (its device engine and its host engine alike)."""
    img = _rgb("img128")
    got = mining.capture_clouds(img, device="cpu")
    for engine in ("device", "host"):
        want = jmining.capture_clouds(img, engine=engine)
        assert len(got) == len(want) > 0
        assert all(np.array_equal(a, b) for a, b in zip(got, want))


def _files(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


def test_mine_bank_writes_the_jax_packages_files(tmp_path):
    """mine_bank over two images, the second run resumed from the
    checkpoint the first wrote after its first image."""
    imgs = [_rgb("img64"), _rgb("quilt128")]
    want = jmining.mine_bank(imgs, tmp_path / "jax", engine="device")
    ck = str(tmp_path / "ck.npz")
    assert mining.mine_bank(imgs[:1], tmp_path / "part", checkpoint=ck,
                            device="cpu")[1] > 0
    got = mining.mine_bank(imgs, tmp_path / "port", checkpoint=ck,
                           device="cpu")
    assert got == want and want[0] > 0
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_mine_bank2d_writes_the_jax_packages_files(tmp_path):
    imgs = [_rgb("img64")]
    want = jmining.mine_bank2d(imgs, tmp_path / "jax", engine="device")
    got = mining.mine_bank2d(imgs, tmp_path / "port", device="cpu")
    assert got == want and want[0] > 0
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


@pytest.mark.parametrize("fn", ["capture_clouds", "evaluate_candidates",
                                "mine_bank", "mine_bank2d"])
def test_mining_defaults_to_the_card(fn, monkeypatch, tmp_path):
    f = getattr(mining, fn)
    assert inspect.signature(f).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = _rgb("img64")
    args = {"capture_clouds": (img,),
            "evaluate_candidates": (mining.capture_clouds(img, device="cpu"),),
            "mine_bank": ([img], tmp_path),
            "mine_bank2d": ([img], tmp_path)}[fn]
    with pytest.raises(RuntimeError, match="is_available"):
        f(*args)
