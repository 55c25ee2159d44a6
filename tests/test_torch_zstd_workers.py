"""The port's zstd worker pool against the JAX package's YAIK_ZSTD_WORKERS,
on the CPU.

`encoder.context._ZstdBatch.run(workers=None)` fans a batch's streams over
the process's pool (one thread per usable core unless `workers` says
fewer); each stream is an independent one-shot compression with its
thread's own CCtx, so the worker count must never show in the bytes. Every
comparison is exact: the slot-by-slot results of tests/test_zstd_workers.py's
24 seeded jobs against the JAX package's serial run, and whole streams
(img128 RGB; sprite256 RGBA with the alpha chunks), emitted on the pool and
on the calling thread, against the JAX package's `encode_image` with
YAIK_ZSTD_WORKERS=4, run in this process (the same zstd).
"""
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from yaik_tpu.encoder import bank as jax_bankmod
from yaik_tpu.encoder.context import _ZstdBatch as JaxZstdBatch
from yaik_tpu.encoder.context import encode_image as jax_encode_image
from yaik_tpu_torch.encoder import api, batch, context
from yaik_tpu_torch.encoder import bank as bankmod
from yaik_tpu_torch.encoder.context import _ZstdBatch

FIX = pathlib.Path(__file__).parent / "fixtures"
IMAGES = {"img128": "RGB", "sprite256": "RGBA"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while these tests run: the suite runs several
    workers on the host's cores, and torch's default of one thread per
    core each oversubscribes them many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def bank():
    return bankmod.load_bank(str(FIX / "Bank3D"))


@pytest.fixture(scope="module")
def jax_bank():
    return jax_bankmod.load_bank(str(FIX / "Bank3D"))


def _image(name):
    return np.asarray(Image.open(FIX / f"{name}.png").convert(IMAGES[name]))


@pytest.fixture(scope="module")
def scored(bank):
    """Each image scored once on the CPU: (image, accepts, t3)."""
    out = {}
    for name in IMAGES:
        img = _image(name)
        out[name] = (img, *api.score_image(img, bank, device="cpu"))
    return out


@pytest.fixture(scope="module")
def jax_streams():
    """The JAX package's streams, filled by the tests (each needs its own
    monkeypatch to set YAIK_ZSTD_WORKERS)."""
    return {}


def _jobs():
    """tests/test_zstd_workers.py's 24 jobs: compressible and noisy
    payloads of varied sizes, at levels 18 and 5."""
    rng = np.random.default_rng(7)
    jobs = []
    for i in range(24):
        if i % 3:
            d = np.repeat(rng.integers(0, 9, 200 + 37 * i), 11
                          ).astype(np.uint8).tobytes()
        else:
            d = rng.integers(0, 256, 500 + 100 * i).astype(np.uint8
                                                           ).tobytes()
        jobs.append((d, 18 if i % 4 else 5))
    return jobs


def _run(cls, jobs, *workers):
    zb = cls()
    handles = [zb.add(d, lv) for d, lv in jobs]
    zb.run(*workers)
    return [zb.get(h) for h in handles]


@pytest.mark.parametrize("workers", [0, 2, 3, 8, None],
                         ids=["0", "2", "3", "8", "default"])
def test_zstd_batch_equals_the_jax_batch_slot_by_slot(workers, monkeypatch):
    monkeypatch.delenv("YAIK_ZSTD_WORKERS", raising=False)
    jobs = _jobs()
    want = _run(JaxZstdBatch, jobs)
    got = _run(_ZstdBatch, jobs, workers)
    assert len(got) == len(want) == 24
    for h, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"slot {h} at workers={workers}"


def test_zstd_batches_flushed_at_once_share_one_pool():
    """Emission threads flush their batches at the same time (more threads
    than cores, the interpreter switching threads often): each batch's
    results stay its own and in slot order, and the first flushes make one
    pool between them."""
    jobs = _jobs()
    want = _run(_ZstdBatch, jobs, 0)
    n = context._cores() + 2
    outs, pools = [None] * n, [None] * n
    start = threading.Barrier(n)

    def flush(k):
        start.wait()
        pools[k] = context._pool()
        outs[k] = _run(_ZstdBatch, jobs[k:] + jobs[:k], *[(), (3,)][k % 2])

    threads = [threading.Thread(target=flush, args=(k,)) for k in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for k, got in enumerate(outs):
        assert got == want[k:] + want[:k], k
    assert all(p is context._POOL for p in pools)


_FORK_SCRIPT = """
import os, select, signal, sys
sys.path.insert(0, sys.argv[1])
from yaik_tpu_torch.encoder.context import _ZstdBatch

DATA = [os.urandom(100_000) + bytes(50_000) for _ in range(16)]

def run(*workers):
    zb = _ZstdBatch()
    for d in DATA:
        zb.add(d)
    zb.run(*workers)
    return zb.results

# the parent's pool starts a thread per stream in flight, at least two
want = run()
r, w = os.pipe()
pid = os.fork()
if pid == 0:                      # two streams at a time: no new thread
    try:
        os.write(w, b"1" if run(2) == want else b"0")
    finally:
        os._exit(0)
answered = select.select([r], [], [], 60)[0]
if not answered:
    os.kill(pid, signal.SIGKILL)
os.waitpid(pid, 0)
print("equal" if answered and os.read(r, 1) == b"1" else
      "different" if answered else "hung")
"""


def test_a_forked_child_compresses_on_a_pool_of_its_own():
    """After the parent's pool exists, a child made by fork() (which
    inherits the pool but none of its threads) still compresses its
    batches, to the parent's bytes. Run in a fresh interpreter that loads
    no jax, whose threads a fork would copy mid-flight."""
    out = subprocess.run(
        [sys.executable, "-c", _FORK_SCRIPT, str(FIX.parent.parent)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "equal", out.stdout


@pytest.mark.parametrize("workers", [0, 4])
def test_a_stream_that_fails_to_compress_raises(workers):
    """A capacity too small for a stream's frame fails in zstd: `run`
    raises, and leaves no results to read."""
    zb = _ZstdBatch()
    for d, lv in _jobs()[:5]:
        zb.add(d, lv)
    zb.add(np.arange(4000, dtype=np.uint8).tobytes(), 18, cap=8)
    with pytest.raises(RuntimeError, match="ZSTD_compress failed"):
        zb.run(workers)
    assert zb.results is None


@pytest.mark.parametrize("workers", [0, None], ids=["0", "default"])
@pytest.mark.parametrize("name", list(IMAGES))
def test_emit_image_bytes_at_every_worker_count(name, workers, scored,
                                                jax_bank, jax_streams,
                                                monkeypatch):
    """emit_image with its streams compressed on the calling thread (a
    deferred batch run at 0 workers) and on the pool (the default): the JAX
    package's bytes with YAIK_ZSTD_WORKERS=4 (img128: RGB with the fixed
    level-18 streams; sprite256: RGBA with the alpha chunks' level
    sweep)."""
    img, accepts, t3 = scored[name]
    if name not in jax_streams:
        monkeypatch.setenv("YAIK_ZSTD_WORKERS", "4")
        jax_streams[name] = jax_encode_image(img, jax_bank)
    if workers is None:
        got = api.emit_image(img, accepts, t3)
    else:
        zb = _ZstdBatch()
        assemble = api.emit_image(img, accepts, t3, defer=zb)
        zb.run(workers)
        got = assemble()
    assert got == jax_streams[name]


def test_host_engine_encode_equals_the_jax_pool(bank, jax_bank, monkeypatch):
    """encode_image(engine="host") on the pool: the JAX host engine's bytes
    with YAIK_ZSTD_WORKERS=4."""
    img = np.asarray(Image.open(FIX / "img64.png").convert("RGB"))
    monkeypatch.setenv("YAIK_ZSTD_WORKERS", "4")
    want = jax_encode_image(img, jax_bank)
    assert api.encode_image(img, bank, engine="host") == want


def test_batch_entry_points_on_the_pool(bank, monkeypatch):
    """encode_batch and encode_image_banded on the pool (one shared batch
    for the images, and one per band's image): encode_image's bytes with
    every stream compressed on the calling thread."""
    img = np.asarray(Image.open(FIX / "img64.png").convert("RGB"))
    imgs = [img, np.ascontiguousarray(np.roll(img, 8, axis=1)[::-1])]
    with monkeypatch.context() as serial:
        serial.setattr(context, "_cores", lambda: 1)
        want = [api.encode_image(im, bank, device="cpu") for im in imgs]
    assert batch.encode_batch(imgs, bank, device="cpu") == want
    assert batch.encode_image_banded(imgs[0], bank, device="cpu",
                                     band_rows=32) == want[0]
