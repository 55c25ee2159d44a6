"""The check that decides `correct`, against its controls and faults.

CPU tests drive a whole run (set-up, warm-up, window, check) with the
harness's look for a card skipped (`device="cpu"`, the kernels' plain
versions), in a scratch checkout whose cells run the benchmark's four
traffic mixes on a 128x128 configuration (its pool made by the plain
encoder), and see `correct` come out true for the program as it is and
false for each control and for each fault a cell can have: an answer
altered where it is produced, and half of a batch left out. A 128x128 RGBA
configuration, added as files with a driver and a traffic mix of its own,
runs under decode-one and encode-one-rgba, and the alpha faults (an alpha
byte altered, the alpha channel left out, an ALPM payload altered) read not
correct. The `cuda` test reads the controls on the card at the cells' own
sizes, on three seeds each:

    python -m pytest portbench/tests/test_portbench_correct.py -q -m cuda -s
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.harness import bench, check  # noqa: E402
from portbench.harness import control  # noqa: E402

SEED = 2 ** 31 + 77
TRAFFIC = ("decode-corpus", "decode-one", "encode-one", "encode-corpus")


def _lut():
    with open(os.path.join(ROOT, "portbench", "data", "LutFile.lut"),
              "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A scratch checkout with a 128x128 configuration of 3 images, its
    pool made by the plain encoder, and a cell for each traffic mix."""
    from portbench.gen import images
    from portbench.reference import bank, context, encoder
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("illust*", "__pycache__"))
    with open(os.path.join(ROOT, "portbench/configs/illust512.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny128", height=128, width=128,
               pool="portbench/data/tiny128")
    cfg["images"].update(bases=3, variants=1)
    (root / "portbench/configs/tiny128.json").write_text(json.dumps(cfg))
    (root / "portbench/data/tiny128").mkdir()
    b3 = bank.load_bank(str(root / "portbench/data/Bank3D"))
    for i, img in enumerate(images.config_images(cfg)):
        (root / f"portbench/data/tiny128/{i:03d}.yaik").write_bytes(
            encoder.encode_image(img, b3,
                                 context.EncoderConfig(**cfg["encoder"])))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"] = [{"name": "tiny128", "source": "x", "reduced": [],
                     "file": "portbench/configs/tiny128.json", "why": "x"}]
    b["workloads"] = [{"name": f"tiny128.{t}", "config": "tiny128",
                       "traffic": t, "chips": 1, "why": "x"}
                      for t in TRAFFIC]
    for m in b["end_to_end"]:
        m.pop("workloads", None)
    for m in b["per_layer"]:
        m["workloads"] = [w["name"] for w in b["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return str(root)


def judged(cell_name, entry=None, seconds=0.1, device="cpu", seed=SEED,
           root=ROOT):
    cell = bench.load_cell(cell_name, root=root)
    run, kept, inputs, golden = bench.run_cell(
        cell, seed, seconds, False, device, time.perf_counter(),
        entry=entry, log=lambda s: None)
    ok, shown = bench.judge(run, kept, inputs, golden)
    failed = sum(len(c.items) for c in run.calls) - run.items_done
    return ok and failed == 0, {k: v["value"] for k, v in shown.items()}


@contextlib.contextmanager
def patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def half_batch(fn):
    return lambda items, *a, **k: fn(items, *a, **k)[: len(items) // 2]


def test_decode_sound_run_is_correct(tiny):
    ok, n = judged("tiny128.decode-one", root=tiny)
    assert ok and n["pixels_differing"] == 0 and n["answers_checked"] >= 1


def test_decode_control_is_not_correct(tiny):
    ok, n = judged("tiny128.decode-one", entry=control.decode_entry(_lut()),
                   root=tiny)
    assert not ok and n["pixels_differing"] > 0


def test_decode_answer_altered_where_produced(tiny):
    from yaik_tpu_torch.decoder import engine

    def make(fn):
        def altered(*a, **k):
            out = fn(*a, **k).copy()
            out[7, 9, 1] ^= 1
            return out
        return altered
    with patched(engine, "decode_plan", make):
        ok, n = judged("tiny128.decode-one", root=tiny)
    assert not ok and n["pixels_differing"] > 0


def test_decode_half_of_the_batch_left_out(tiny):
    from yaik_tpu_torch.parallel import batch
    with patched(batch, "decode_corpus", half_batch):
        ok, n = judged("tiny128.decode-corpus", root=tiny)
    assert not ok and n["answers_missing"] > 0


@pytest.mark.parametrize("traffic", ["encode-one", "encode-corpus"])
def test_encode_sound_run_is_correct(tiny, traffic):
    ok, n = judged(f"tiny128.{traffic}", root=tiny)
    assert ok and n["streams_differing"] == 0 and n["answers_checked"] >= 1
    assert n["size_over_pct"] <= check.LIMITS["size_over_pct"]
    assert "alpm_over_sweep_pct" not in n       # RGB: no ALPM, no number


def test_encode_control_is_not_correct(tiny):
    ok, n = judged("tiny128.encode-corpus", entry=control.encode_entry(4),
                   root=tiny)
    assert not ok and n["streams_differing"] > 0


@pytest.mark.parametrize("traffic", ["encode-one", "encode-corpus"])
def test_encode_size_control_is_not_correct(tiny, traffic):
    """The program at zstd level 3 for 18: the same content, so
    `streams_differing` stays 0, in larger streams. (The 128x128 images'
    short streams grow less at level 9, 2.5-4.2%, than the cells' at their
    own size, 5.5-6.4%, which the `cuda` test reads.)"""
    ok, n = judged(f"tiny128.{traffic}", entry=control.encode_level_entry(3),
                   root=tiny)
    assert n["streams_differing"] == 0 and n["answers_checked"] >= 1
    assert not ok and n["size_over_pct"] > check.LIMITS["size_over_pct"]


def test_encode_answer_altered_where_produced(tiny):
    """One byte of the last raw stream an image queues for zstd (its 1D
    pixels) flipped before compression."""
    from yaik_tpu_torch.encoder import context

    def make(add):
        def altered(self, data, *a, **k):
            data = bytes(data)
            if len(data) > 64 and len(self.jobs) >= 20:
                data = data[:40] + bytes([data[40] ^ 0x10]) + data[41:]
            return add(self, data, *a, **k)
        return altered
    with patched(context._ZstdBatch, "add", make):
        ok, n = judged("tiny128.encode-one", root=tiny)
    assert not ok and n["streams_differing"] > 0


def test_encode_half_of_the_batch_left_out(tiny):
    from yaik_tpu_torch.encoder import batch
    with patched(batch, "encode_corpus", half_batch):
        ok, n = judged("tiny128.encode-corpus", root=tiny)
    assert not ok and n["answers_missing"] > 0


BANDS_DRIVER = '''"""Band decode of a mixed-size pack: each stream through
`decode_spatial` in two bands, the pool drawn from several directories."""
import os

from portbench.harness import loop
from portbench.reference.headers import FileHeader

KIND = "decode"


def inputs(cell):
    streams = []
    for d in cell.config["pools"]:
        for n in sorted(os.listdir(os.path.join(cell.root, d))):
            if n.endswith(".yaik"):
                with open(os.path.join(cell.root, d, n), "rb") as f:
                    streams.append(f.read())
    import yaik_tpu_torch
    with open(os.path.join(cell.root, cell.config["lut"]), "rb") as f:
        lut = f.read()
    heads = [FileHeader.unpack(s) for s in streams]
    return loop.Inputs(n=len(streams), streams=streams, lut=lut,
                       lut_bank=yaik_tpu_torch.assign_lut(lut),
                       pixels=[h.width * h.height for h in heads]), streams


def entry(inputs, device, n_bands=2):
    from yaik_tpu_torch.parallel.batch import decode_spatial
    return lambda idx: [decode_spatial(inputs.streams[i], inputs.lut_bank,
                                       device=device, n_bands=n_bands)
                        for i in idx]
'''


def test_a_mix_with_a_new_driver_and_mixed_sizes_added_as_files(tiny,
                                                                 tmp_path):
    """A later mix brings its own driver (a new entry point, its own
    inputs) and a configuration whose items differ in size, as new files
    and entries in BENCHMARK.json alone; the run is judged by the check
    of the driver's kind and counts each item's own pixels."""
    from portbench.gen import images
    from portbench.reference import bank, context, encoder
    root = tmp_path / "checkout"
    shutil.copytree(tiny, root)
    with open(os.path.join(tiny, "portbench/configs/tiny128.json")) as f:
        cfg = json.load(f)
    small = dict(cfg, height=64, width=96,
                 images=dict(cfg["images"], bases=1, variants=1))
    (root / "portbench/data/pack96").mkdir()
    b3 = bank.load_bank(str(root / "portbench/data/Bank3D"))
    (root / "portbench/data/pack96/000.yaik").write_bytes(encoder.encode_image(
        images.config_images(small)[0], b3,
        context.EncoderConfig(**cfg["encoder"])))
    (root / "portbench/configs/pack.json").write_text(json.dumps(
        {"name": "pack", "lut": cfg["lut"], "reduced": [],
         "pools": ["portbench/data/tiny128", "portbench/data/pack96"]}))
    (root / "portbench/drivers/decode_bands.py").write_text(BANDS_DRIVER)
    (root / "portbench/traffic/bands.json").write_text(json.dumps(
        {"driver": "decode_bands", "per_call": 2, "kwargs": {"n_bands": 2},
         "check_sample": "all"}))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "pack", "source": "x", "reduced": [],
                         "file": "portbench/configs/pack.json", "why": "x"})
    b["workloads"].append({"name": "pack.bands", "config": "pack",
                           "traffic": "bands", "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*.py")
              if p.name != "decode_bands.py"}

    cell = bench.load_cell("pack.bands", root=str(root))
    run, kept, inputs, golden = bench.run_cell(
        cell, SEED, 0.1, False, "cpu", time.perf_counter(),
        log=lambda s: None)
    ok, shown = bench.judge(run, kept, inputs, golden)
    done = [i for c in run.calls if c.ok for i in c.items]
    assert ok and shown["pixels_differing"]["value"] == 0
    assert shown["answers_checked"]["value"] == len(done) >= 2
    assert sorted(set(inputs.pixels)) == [64 * 96, 128 * 128]
    assert bench.load_reader("decode_mpix_s", str(root)).read(run) == \
        pytest.approx(sum(inputs.pixels[i] for i in done) / 1e6 /
                      run.window_s)
    assert all(p.read_bytes() == v for p, v in before.items())


RGBA_DRIVER = '''"""encode_image of 128x128 RGBA sprites: make_main's RGB
under an alpha of seeded discs inside a border of wholly transparent 16x16
tiles (so MIPM is written) with a transparent tile among them, binary edges
on the first image and anti-aliased edges on the others."""
import numpy as np

from portbench.harness import loop

KIND = "encode"


def alpha(rng, h, w, soft):
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.zeros((h, w))
    for _ in range(3):
        cy, cx = rng.uniform(40, h - 40), rng.uniform(40, w - 40)
        d = np.hypot(yy - cy, xx - cx) - rng.uniform(10, 22)
        a = np.maximum(a, np.clip(0.5 - d / 3, 0, 1) if soft else d <= 0)
    a[:16] = a[-16:] = a[:, :16] = a[:, -16:] = 0
    a[64:80, 64:80] = 0
    return np.round(a * 255).astype(np.uint8)


def sprites(cfg):
    from portbench.gen import images
    return [np.dstack([im, alpha(np.random.default_rng(
        cfg["images"]["seed"] + 1000 + i), *im.shape[:2], i > 0)])
        for i, im in enumerate(images.config_images(cfg))]


def inputs(cell):
    inp, streams = loop.pool_inputs(cell, KIND)
    inp.images = sprites(cell.config)
    return inp, streams


def entry(inputs, device, **kw):
    import yaik_tpu_torch
    return lambda idx: [yaik_tpu_torch.encode_image(
        inputs.images[i], inputs.bank3d, device=device,
        config=inputs.encoder_config, **kw) for i in idx]
'''


@pytest.fixture(scope="module")
def tiny_rgba(tiny, tmp_path_factory):
    """The scratch checkout of `tiny` with a 128x128 RGBA configuration
    added as files: a driver of its own (`drivers/encode_image_rgba.py`,
    whose `inputs(cell)` makes the sprites) under a traffic file of its own
    (`encode-one-rgba`, encode-one with that driver), its pool made by the
    plain encoder (MIPM, and ALPM in 1-bit and sparse 6-bit modes), and its
    cells under decode-one and encode-one-rgba."""
    from portbench.harness import loop
    from portbench.reference import bank, context, decoder, encoder
    from portbench.reference.headers import AlphaHeader
    root = tmp_path_factory.mktemp("rgba") / "checkout"
    shutil.copytree(tiny, root)
    (root / "portbench/drivers/encode_image_rgba.py").write_text(RGBA_DRIVER)
    mix = json.loads((root / "portbench/traffic/encode-one.json").read_text())
    mix["driver"] = "encode_image_rgba"
    (root / "portbench/traffic/encode-one-rgba.json").write_text(
        json.dumps(mix))
    cfg = json.loads((root / "portbench/configs/tiny128.json").read_text())
    cfg.update(name="tiny_rgba128", channels=4,
               pool="portbench/data/tiny_rgba128")
    cfg["encoder"]["alpha_force_8bit"] = False
    (root / "portbench/configs/tiny_rgba128.json").write_text(json.dumps(cfg))
    (root / "portbench/data/tiny_rgba128").mkdir()
    b3 = bank.load_bank(str(root / "portbench/data/Bank3D"))
    modes = set()
    driver = loop.load_driver("encode_image_rgba", str(root))
    for i, img in enumerate(driver.sprites(cfg)):
        assert img.shape == (128, 128, 4)
        s = encoder.encode_image(img, b3,
                                 context.EncoderConfig(**cfg["encoder"]))
        chunks = list(decoder.iter_chunks(s))
        assert [c[0] for c in chunks[:2]] == [b"MIPM", b"ALPM"]
        modes.add(AlphaHeader.unpack(chunks[1][2]).parameters & 7)
        (root / f"portbench/data/tiny_rgba128/{i:03d}.yaik").write_bytes(s)
    assert modes == {1, 3}, modes        # 1-bit, sparse 6-bit inverse
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny_rgba128", "source": "x",
                         "reduced": [], "why": "x",
                         "file": "portbench/configs/tiny_rgba128.json"})
    for t in ("decode-one", "encode-one-rgba"):
        b["workloads"].append({"name": f"tiny_rgba128.{t}",
                               "config": "tiny_rgba128", "traffic": t,
                               "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return str(root)


@pytest.mark.parametrize("traffic", ["decode-one", "encode-one-rgba"])
def test_rgba_sound_run_is_correct(tiny_rgba, traffic):
    ok, n = judged(f"tiny_rgba128.{traffic}", root=tiny_rgba)
    assert ok and n["answers_checked"] >= 1, n
    assert n.get("pixels_differing", 0) == n.get("streams_differing", 0) == 0
    assert n.get("size_over_pct", 0) <= check.LIMITS["size_over_pct"]
    if traffic == "encode-one-rgba":
        assert n["alpm_over_sweep_pct"] == 0, n


def test_rgba_encode_alpm_at_level5_is_not_correct(tiny_rgba):
    """The control of the ALPM level sweep: the program compresses each
    ALPM payload at zstd level 5 alone, the same content in a larger
    payload, which only `alpm_over_sweep_pct` sees."""
    from portbench.reference import zstd
    from yaik_tpu_torch.encoder import alpha as port_alpha

    def make(sweep):
        return lambda data: zstd.compress(data, 5, len(data) * 2)
    with patched(port_alpha, "_zstd_sweep", make):
        ok, n = judged("tiny_rgba128.encode-one-rgba", root=tiny_rgba)
    assert n["streams_differing"] == 0 and n["answers_checked"] >= 1, n
    assert n["size_over_pct"] <= check.LIMITS["size_over_pct"], n
    assert not ok and n["alpm_over_sweep_pct"] > 0, n


@pytest.mark.parametrize("fault", ["alpha_byte_altered", "alpha_dropped"])
def test_rgba_decode_fault_is_not_correct(tiny_rgba, fault):
    """One alpha byte of the answer altered where it is produced, or the
    answer's alpha channel left out."""
    from yaik_tpu_torch.decoder import engine

    def make(fn):
        def faulty(*a, **k):
            out = fn(*a, **k)
            assert out.shape[2] == 4
            if fault == "alpha_dropped":
                return out[:, :, :3].copy()
            out = out.copy()
            out[70, 40, 3] ^= 1
            return out
        return faulty
    with patched(engine, "decode_plan", make):
        ok, n = judged("tiny_rgba128.decode-one", root=tiny_rgba)
    assert not ok and n["pixels_differing"] > 0, n


def test_rgba_encode_alpm_payload_altered_is_not_correct(tiny_rgba):
    """One byte of each ALPM payload altered before the program's level
    sweep compresses it."""
    from yaik_tpu_torch.encoder import alpha as port_alpha

    def make(sweep):
        return lambda data: sweep(bytes([data[0] ^ 0x04]) + data[1:])
    with patched(port_alpha, "_zstd_sweep", make):
        ok, n = judged("tiny_rgba128.encode-one-rgba", root=tiny_rgba)
    assert not ok and n["streams_differing"] == n["answers_checked"] >= 1, n


CONTROLS = {"illust512.decode-corpus": ("decode",),
            "illust512.decode-one": ("decode",),
            "illust4k.encode-one": ("reject4", "zstd9", "zstd3")}
SEEDS = {"zstd3": (2 ** 31 + 111,)}


def _control(name):
    if name == "decode":
        return control.decode_entry(_lut())
    if name == "reject4":
        return control.encode_entry(4)
    return control.encode_level_entry(int(name[4:]))


@pytest.mark.cuda
@pytest.mark.parametrize("cell,name", [(c, n) for c in sorted(CONTROLS)
                                       for n in CONTROLS[c]])
def test_controls_on_the_card(cell, name):
    """Each cell's controls at the cell's own size, three seeds (the
    zstd-3 reading one): `correct` false every time; prints the numbers
    compared."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in SEEDS.get(name, (2 ** 31 + 101, 2 ** 31 + 102,
                                 2 ** 31 + 103)):
        ok, n = judged(cell, entry=_control(name), seconds=2.0,
                       device="cuda", seed=seed)
        print(f"control {name} {cell} seed {seed}: correct {ok} {n}",
              flush=True)
        assert not ok
