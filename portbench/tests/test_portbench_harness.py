"""CPU tests of the benchmark's harness: lookup by name, cells and metrics
added as files, the import rules, the frozen reference against the goldens,
the metric arithmetic on hand-made traces, the frozen roofline counts, and
the refusal to run without a card.

    python -m pytest portbench/tests -q
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.harness import bench, loop, peaks, readers, trace  # noqa: E402
from portbench.reference import canonical, decoder, zstd  # noqa: E402

FIX = os.path.join(ROOT, "tests", "fixtures")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_cells_found_by_name():
    b = _bench()
    for w in b["workloads"]:
        cell = bench.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["driver"] in ("decode_image", "decode_corpus",
                                          "encode_image", "encode_corpus")
        assert cell.driver.KIND == cell.traffic["driver"][:6]
        assert callable(cell.driver.entry)
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:       # moves a metric the cell reports
            assert m["moves"] in names
        for m in cell.end_to_end + cell.per_layer:
            assert callable(bench.load_reader(m["name"]).read)


def test_every_metric_and_file_of_the_benchmark_exists():
    b = _bench()
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "metrics", m["name"] + ".py")), m["name"]
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        pool = os.path.join(ROOT, cfg["pool"])
        n = cfg["images"]["bases"] * cfg["images"]["variants"]
        assert len([p for p in os.listdir(pool) if p.endswith(".yaik")]) == n


def test_a_cell_config_and_metric_added_as_files_alone(tmp_path):
    """A later change adds a configuration, a traffic mix and a metric as
    new files (and entries in BENCHMARK.json); no file of the harness is
    edited, and the harness finds all three by name."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("data", "__pycache__"))
    b = _bench()
    cfg = json.loads((root / "portbench/configs/illust512.json").read_text())
    cfg["name"] = "icons128"
    cfg["height"] = cfg["width"] = 128
    (root / "portbench/configs/icons128.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/encode-corpus-64.json").write_text(
        json.dumps({"driver": "encode_corpus", "per_call": "all",
                    "kwargs": {"batch_size": 64, "emit_workers": 0}}))
    (root / "portbench/metrics/calls_per_s.py").write_text(
        "def read(run):\n    return len(run.calls) / run.window_s\n")
    b["configs"].append({"name": "icons128", "source": "x",
                         "file": "portbench/configs/icons128.json",
                         "reduced": []})
    b["workloads"].append({"name": "icons128.encode-corpus",
                           "config": "icons128",
                           "traffic": "encode-corpus-64", "chips": 1,
                           "why": "x"})
    b["per_layer"].append({"name": "calls_per_s", "unit": "1/s",
                           "better": "higher", "source": "host_clock",
                           "layer": "x", "moves": "encode_mpix_s",
                           "workloads": ["icons128.encode-corpus"]})
    b["end_to_end"] = [dict(m, workloads=m["workloads"]
                            + ["icons128.encode-corpus"])
                       if m["name"] == "encode_mpix_s" else m
                       for m in b["end_to_end"]]
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = bench.load_cell("icons128.encode-corpus", root=str(root))
    assert cell.config["height"] == 128
    assert cell.traffic["kwargs"]["batch_size"] == 64
    assert [m["name"] for m in cell.per_layer] == ["calls_per_s"]
    assert [m["name"] for m in cell.end_to_end] == ["encode_mpix_s",
                                                     "setup_s"]
    run = bench.Run(cell, 1.0, window_s=2.0,
                    calls=[loop.Call(0, 1, [0], True)] * 4)
    assert bench.load_reader("calls_per_s", root=str(root)).read(run) == 2.0


def _imports_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in sys.modules}))"], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_run_imports_neither_jax_nor_the_jax_package():
    """Whole top-level names: `yaik_tpu_torch` is the port, `yaik_tpu` the
    JAX package."""
    mods = _imports_after(
        "import sys; sys.path.insert(0, '.')\n"
        "import glob\n"
        "from portbench.harness import bench, loop, trace\n"
        "from portbench.gen import images\n"
        "import yaik_tpu_torch, yaik_tpu_torch.parallel.batch\n"
        "import yaik_tpu_torch.encoder.batch, yaik_tpu_torch.utils.profiler\n"
        "for p in glob.glob('portbench/metrics/*.py'):\n"
        "    bench.load_reader(p.split('/')[-1][:-3])\n"
        "trace.install_spans([])\n"
        "trace.record_calls(['grad_plane', 't3_merged', 'grad_score'], {})\n")
    assert "yaik_tpu_torch" in mods
    assert not mods & set(bench.FORBIDDEN), mods & set(bench.FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    mods = _imports_after(
        "import sys; sys.path.insert(0, '.')\n"
        "from portbench.reference import canonical, decoder, encoder\n"
        "from portbench.harness import check\n"
        "from portbench.gen import images, make_pool\n")
    assert not mods & {"yaik_tpu_torch", "torch", *bench.FORBIDDEN}


def test_sources_name_no_forbidden_module():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "portbench")):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(dirpath, name)) as f:
                for line in f:
                    words = line.split()
                    if words[:1] in (["import"], ["from"]) and len(words) > 1:
                        top = words[1].split(".")[0].rstrip(",")
                        assert top not in bench.FORBIDDEN, (name, line)


@pytest.mark.parametrize("name", ["img64", "img128", "quilt128", "img512",
                                  "img512b"])
def test_frozen_reference_decoder_reproduces_goldens(name):
    with open(os.path.join(FIX, "LutFile.lut"), "rb") as f:
        lut = f.read()
    with open(os.path.join(FIX, name + ".yaik"), "rb") as f:
        px = decoder.decode(f.read(), lut)
    gold = np.load(os.path.join(FIX, name + ".dec.npz"))
    np.testing.assert_array_equal(px, gold[list(gold.keys())[0]])


def test_lut_and_bank_copies_equal_the_fixtures():
    for rel in ["LutFile.lut"] + [os.path.join("Bank3D", n) for n in
                                  os.listdir(os.path.join(FIX, "Bank3D"))]:
        with open(os.path.join(FIX, rel), "rb") as a, \
                open(os.path.join(ROOT, "portbench", "data", rel), "rb") as b:
            assert a.read() == b.read(), rel


def test_canonical_form_ignores_zstd_bytes_only():
    with open(os.path.join(FIX, "img128.yaik"), "rb") as f:
        s = f.read()
    ref = canonical.canonical(s)
    assert canonical.canonical(s) == ref
    # the 1D chunk's pixel stream recompressed at another level: other
    # bytes, same canonical form
    tag, off, body = list(decoder.iter_chunks(s))[-1]
    assert tag == b"1DTL"
    from portbench.reference.context import _chunk
    from portbench.reference.headers import Header1D

    def with_pixels(z):
        hdr = Header1D.unpack(body)
        z_type = body[Header1D.size():Header1D.size() + hdr.stream_type_cnt]
        hdr.stream_pixel_bit = len(z)
        return (s[:off - 8] + _chunk(b"1DTL", hdr.pack() + z_type + z)
                + s[off + len(body):])

    hdr = Header1D.unpack(body)
    z_pix = body[Header1D.size() + hdr.stream_type_cnt:][
        :hdr.stream_pixel_bit]
    raw = zstd.decompress(z_pix, hdr.stream_pixel_uncmp)
    z2 = zstd.compress(raw, 1)
    assert z2 != z_pix
    other = with_pixels(z2)
    assert other != s and canonical.canonical(other) == ref
    # one decompressed byte changed: a different form
    bad = with_pixels(zstd.compress(bytes([raw[0] ^ 1]) + raw[1:], 18))
    assert canonical.canonical(bad) != ref


def test_interval_union_gaps_and_labels():
    iv = [(10, 20), (15, 30), (40, 50), (45, 46), (60, 200)]
    assert trace.union_ns(iv, 0, 100) == 20 + 10 + 40
    assert trace.union_ns(iv, 12, 48) == 18 + 8
    assert trace.gaps_ns(iv, 0, 100) == [(0, 10), (30, 40), (50, 60)]
    spans = [("pack", 0, 100), ("plan", 20, 40)]
    assert trace.host_timeline(spans, 0, 150) == [
        (0, 20, "pack"), (20, 40, "plan"), (40, 100, "pack"),
        (100, 150, "unspanned")]
    # a gap is split where the host's span changes: 0-10 pack, 30-40 plan,
    # 50-60 pack; the device is busy in between and from 60 on
    idle = trace.idle_by_label(iv[:4] + [(60, 100)], spans, 0, 100)
    assert idle == {"pack": pytest.approx(20e-9), "plan": pytest.approx(
        10e-9)}


def test_p95_is_over_every_request():
    lat = list(range(1, 101))                       # 1..100
    assert trace.nearest_rank(lat, 0.95) == 95
    assert trace.nearest_rank([5.0], 0.95) == 5.0
    cell = bench.load_cell("illust512.decode-one")
    calls = [loop.Call(0.0, v / 1e3, [0], True) for v in lat]
    calls[3] = loop.Call(0.0, 1.0, [0], False)        # a failure: longest
    run = bench.Run(cell, 1.0, calls=calls, window_s=5.0)
    p95 = bench.load_reader("decode_p95_ms").read(run)
    assert p95 == pytest.approx(96.0)


def test_rates_are_over_the_whole_window():
    cell = bench.load_cell("illust512.decode-corpus")
    calls = [loop.Call(0, 1, list(range(64)), True),
             loop.Call(1, 2, list(range(64)), False),
             loop.Call(2, 3, list(range(64)), True)]
    run = bench.Run(cell, 2.0, calls=calls, window_s=3.0,
                    item_pixels=[512 * 512] * 64)
    got = bench.load_reader("decode_mpix_s").read(run)
    assert got == pytest.approx(128 * 512 * 512 / 1e6 / 3.0)
    assert bench.load_reader("encode_mpix_s").read(run) is None
    # items of other sizes count with their own pixels
    run.item_pixels = [64 * 64, 2048 * 1024] + [0] * 62
    run.calls = [loop.Call(0, 1, [0, 1, 1], True),
                 loop.Call(1, 2, [0], False)]
    assert bench.load_reader("decode_mpix_s").read(run) == pytest.approx(
        (64 * 64 + 2 * 2048 * 1024) / 1e6 / 3.0)


def test_idle_share_and_device_time():
    cell = bench.load_cell("illust4k.encode-one")
    ev = [("k1", 100, 200, "kernel"), ("k2", 150, 300, "kernel"),
          ("Memcpy DtoH", 500, 600, "memcpy"), ("k1", 900, 1100, "kernel")]
    run = bench.Run(cell, 1.0, calls=[loop.Call(0, 1, [0, 1], True)],
                    window_s=1e-6, window_ns=(0, 1000), device_events=ev,
                    item_pixels=[500_000] * 2, traced=True)
    assert readers.idle_pct(run) == pytest.approx(100 * (1 - 400 / 1000))
    dev = bench.load_reader("scoring_device_ms_per_mpix").read(run)
    assert dev == pytest.approx((100 + 150 + 200) / 1e6 / 1.0)
    n = bench.load_reader("device_launches_per_mpix.encode").read(run)
    assert n == pytest.approx(3.0)
    b = bench.breakdown(run)
    assert b["device_ops"][0] == ["k1", pytest.approx(2e-7)]


def _bound_ms(metric: str, call: dict) -> float:
    return peaks.bound_s(*bench.load_reader(metric).count(call)) * 1e3


def test_roofline_counts_reproduce_the_4k_bounds():
    """PERF.md's kernel table: bench_4k's grad_plane 0.0144 ms (bytes) and
    grad_score 0.0624 ms (operations)."""
    h, w = 2160, 3840
    gp = {"args": [((7, h // 4 + 1, w // 4 + 1), 4), ((h // 4, w // 4), 1)],
          "out": ((h, w), 4)}
    assert _bound_ms("grad_plane_roofline", gp) == pytest.approx(0.0144,
                                                                 abs=5e-5)
    G = sum((h >> sy) * (w >> sx) for sx, sy in
            bench.load_reader("grad_score_roofline").PASSES)
    gs = {"args": [((3, h, w), 4), ((3, h, w), 1), 3], "out": ((G,), 1)}
    assert _bound_ms("grad_score_roofline", gs) == pytest.approx(0.0624,
                                                                 abs=5e-5)
    # a batch of 8 is 8 times one image's work
    gs8 = {"args": [((8, 3, h, w), 4), ((8, 3, h, w), 1), 3],
           "out": ((8, G), 1)}
    assert _bound_ms("grad_score_roofline", gs8) == pytest.approx(
        8 * _bound_ms("grad_score_roofline", gs))


def test_roofline_share_from_calls_and_kernel_events():
    cell = bench.load_cell("illust4k.encode-one")
    h = w = 512
    G = sum((h >> sy) * (w >> sx) for sx, sy in
            bench.load_reader("grad_score_roofline").PASSES)
    call = {"args": [((8, 3, h, w), 4), ((8, 3, h, w), 1), 3],
            "out": ((8, G), 1)}
    bound_ns = _bound_ms("grad_score_roofline", call) * 1e6
    ev = [("void grad_score_kernel(int const*)", 0, int(bound_ns * 2),
           "kernel"), ("other", 0, 10, "kernel")]
    run = bench.Run(cell, 1.0, window_ns=(0, 10 ** 9), device_events=ev,
                    kernel_calls={"grad_score": [call]}, traced=True)
    got = bench.load_reader("grad_score_roofline").read(run)
    assert got == pytest.approx(50.0, rel=1e-3)
    run.kernel_calls = {}
    assert bench.load_reader("grad_score_roofline").read(run) is None


def test_roofline_left_out_where_calls_and_events_differ():
    """A lost kernel event, or a second event the name matches, leaves the
    share unreported rather than wrong."""
    cell = bench.load_cell("illust4k.encode-one")
    h = w = 512
    G = sum((h >> sy) * (w >> sx) for sx, sy in
            bench.load_reader("grad_score_roofline").PASSES)
    call = {"args": [((8, 3, h, w), 4), ((8, 3, h, w), 1), 3],
            "out": ((8, G), 1)}
    ev = [("grad_score_kernel", 0, 10 ** 6, "kernel")]
    run = bench.Run(cell, 1.0, window_ns=(0, 10 ** 9), device_events=ev,
                    kernel_calls={"grad_score": [call]}, traced=True)
    assert "grad_score_roofline" in bench.read_metrics(run)
    run.kernel_calls = {"grad_score": [call, call]}
    assert "grad_score_roofline" not in bench.read_metrics(run)
    run.kernel_calls = {"grad_score": [call]}
    run.device_events = ev * 2
    assert "grad_score_roofline" not in bench.read_metrics(run)


def test_per_layer_metric_without_workloads_is_refused(tmp_path):
    b = _bench()
    b["per_layer"][0].pop("workloads")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("data", "__pycache__"))
    with pytest.raises(ValueError, match="workloads"):
        bench.load_cell("illust512.decode-one", root=str(tmp_path))


def test_stage_sums_and_spans():
    from yaik_tpu_torch.utils import profiler
    with profiler.enable() as prof:
        with profiler.stage("encode:gradient"):
            with profiler.stage("encode:1d"):
                pass
        with profiler.stage("encode:1d"):
            pass
    st = trace.stage_totals(prof)
    assert set(st) == {"encode:gradient", "encode:1d"}
    cell = bench.load_cell("illust512.decode-one")
    run = bench.Run(cell, 1.0, calls=[loop.Call(0, 1, [0], True)] * 2,
                    spans=[("plan", 0, 4_000_000), ("pack", 5_000_000,
                                                    6_000_000),
                           ("upload", 0, 10 ** 9)])
    assert bench.load_reader("plan_pack_ms.decode_one").read(run) == 2.5


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the run exits non-zero and prints no result;
    it never falls back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "illust512.decode-one", "--seed", str(2 ** 31 + 5), "--seconds",
         "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_only_the_benchmark_is_not_enough(tmp_path):
    """In a directory that holds BENCHMARK.json and portbench/ alone the
    run exits non-zero with no result (there is no program to measure)."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "illust512.decode-one", "--seed", "7", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_order_walks_the_pool_in_seeded_permutations():
    a, b = loop.Order(64, 2 ** 31 + 11), loop.Order(64, 2 ** 31 + 11)
    first = a.take(64)
    assert sorted(first) == list(range(64)) and first == b.take(64)
    assert sorted(a.take(64)) == list(range(64))
    c = loop.Order(64, 2 ** 31 + 12)
    assert c.take(64) != first


def test_plain_encoder_remakes_a_committed_stream():
    """The pool's provenance: the frozen encoder makes image 0 of illust512
    again, equal to the committed stream in canonical form (the bytes
    differ only where the zstd library does)."""
    from portbench.gen import images
    from portbench.reference import bank, context, encoder
    with open(os.path.join(ROOT, "portbench/configs/illust512.json")) as f:
        cfg = json.load(f)
    img = images.config_images(dict(cfg, images=dict(cfg["images"],
                                                     bases=1, variants=1)))[0]
    b3 = bank.load_bank(os.path.join(ROOT, cfg["bank3d"]))
    s = encoder.encode_image(img, b3, context.EncoderConfig(**cfg["encoder"]))
    with open(os.path.join(ROOT, cfg["pool"], "000.yaik"), "rb") as f:
        assert canonical.canonical(s) == canonical.canonical(f.read())
