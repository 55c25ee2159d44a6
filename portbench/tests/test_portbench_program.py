"""CPU tests of the metrics that read the port's own spans and counters
(`harness/program.py`): a traced window of each of the three cells' traffic
on 128x128 inputs (the kernels' plain versions, no device events), in which
each new metric reads a number and the stage metrics read the stage names
they read before; and a profile with no spans, as a port that records none
keeps, which leaves the new metrics out.

    python -m pytest portbench/tests/test_portbench_program.py -q
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

from portbench.harness import bench, program, readers, trace  # noqa: E402

SEED = 2 ** 31 + 91
CELLS = {"decode-corpus": "decode_corpus", "decode-one": "decode_one",
         "encode-one": "encode"}
NEW = {"decode_corpus": ["idle_unattributed_pct", "h2d_mb_per_mpix",
                         "d2h_mb_per_mpix", "pack_ms_per_mpix"],
       "decode_one": ["idle_unattributed_pct", "h2d_mb_per_mpix",
                      "d2h_mb_per_mpix", "pack_ms_per_mpix"],
       "encode": ["idle_unattributed_pct", "h2d_mb_per_mpix",
                  "d2h_mb_per_mpix"]}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A scratch checkout with a 128x128 configuration: a pool of the two
    128x128 fixture streams, two generated images, and a cell for each
    traffic mix of the benchmark's cells, reporting every metric."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("illust*", "__pycache__"))
    with open(os.path.join(ROOT, "portbench/configs/illust512.json")) as f:
        cfg = json.load(f)
    cfg.update(name="small128", height=128, width=128,
               pool="portbench/data/small128")
    cfg["images"].update(bases=2, variants=1)
    (root / "portbench/configs/small128.json").write_text(json.dumps(cfg))
    (root / "portbench/data/small128").mkdir()
    for name in ("img128", "quilt128"):
        shutil.copy(os.path.join(ROOT, "tests", "fixtures", name + ".yaik"),
                    root / "portbench/data/small128")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"] = [{"name": "small128", "source": "x", "reduced": [],
                     "file": "portbench/configs/small128.json", "why": "x"}]
    b["workloads"] = [{"name": f"small128.{t}", "config": "small128",
                       "traffic": t, "chips": 1, "why": "x"} for t in CELLS]
    for m in b["end_to_end"]:
        m.pop("workloads", None)
    for m in b["per_layer"]:
        m["workloads"] = [w["name"] for w in b["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return str(root)


@contextlib.contextmanager
def restored():
    """Puts back what a traced run wraps: the functions of `trace.SPANS`,
    the kernel wrappers, the port's `profiler.enable`."""
    from yaik_tpu_torch.ops import kernels
    from yaik_tpu_torch.utils import profiler
    kept = [(trace._owner(m, a), getattr(*trace._owner(m, a)))
            for m, a, _ in trace.SPANS]
    names = [n for n in dir(kernels) if hasattr(getattr(kernels, n),
                                                  "launches")]
    wrappers = {n: getattr(kernels, n) for n in names}
    enable = profiler.enable
    try:
        yield
    finally:
        for (owner, name), fn in kept:
            setattr(owner, name, fn)
        for n, fn in wrappers.items():
            setattr(kernels, n, fn)
        profiler.enable = enable


def traced(root: str, traffic: str):
    cell = bench.load_cell(f"small128.{traffic}", root=root)
    with restored():
        run, *_ = bench.run_cell(cell, SEED, 0.1, True, "cpu",
                                 time.perf_counter(), log=lambda s: None)
        return run, bench.read_metrics(run)


@pytest.mark.parametrize("traffic", list(CELLS))
def test_new_metrics_read_a_number_in_a_traced_window(small, traffic):
    run, got = traced(small, traffic)
    kind = CELLS[traffic]
    for name in NEW[kind]:
        m = got.get(f"{name}.{kind}")
        assert m is not None and m["value"] >= 0, (name, got)
    assert got[f"h2d_mb_per_mpix.{kind}"]["value"] > 0
    assert got[f"d2h_mb_per_mpix.{kind}"]["value"] > 0
    # the window's loop between calls is the only time outside a span
    assert got[f"idle_unattributed_pct.{kind}"]["value"] < 50
    spans = program.program_spans(run)
    assert {n: v[1] for n, v in spans.items()} == pytest.approx(run.stages)
    if kind == "encode":
        assert "zstd_longest_job_pct" in got
        assert 0 < got["zstd_longest_job_pct"]["value"] <= 100
    else:
        assert "zstd_longest_job_pct" not in got
        assert got[f"pack_ms_per_mpix.{kind}"]["value"] > 0


def test_stage_metrics_read_the_stage_names_they_read_before(small):
    """`emit_ms_per_mpix` and `zstd_flush_ms_per_mpix` read the stage
    timers under their names: the port's spans keep the names, each at its
    place, and `trace.stage_totals` sums them as before."""
    run, got = traced(small, "encode-one")
    stages = ("encode:gradient", "encode:3d-emit", "encode:3d-chunk",
              "encode:1d", "emit:assemble")
    assert {"encode:gradient", "encode:3d-emit", "encode:3d-chunk",
            "encode:1d", "encode:zstd-flush"} <= set(run.stages)
    want = readers.per_mpix(run, readers.stage_s(run, stages) * 1e3)
    assert got["emit_ms_per_mpix"]["value"] == pytest.approx(want)
    flush = readers.stage_s(run, ("encode:zstd-flush", "emit:zstd-flush"))
    assert got["zstd_flush_ms_per_mpix"]["value"] == pytest.approx(
        readers.per_mpix(run, flush * 1e3))


def test_a_profile_without_spans_leaves_the_new_metrics_out(small):
    """A port whose profiler keeps no spans (no `events`): every new
    metric reads None."""
    cell = bench.load_cell("small128.decode-one", root=small)
    run = bench.Run(cell, 1.0, traced=True, window_ns=(10, 20))
    with restored():
        program._KEPT[:] = [type("Old", (), {"root": None})()]
        for name in NEW["decode_one"]:
            reader = bench.load_reader(f"{name}.decode_one", root=small)
            assert reader.read(run) is None
        program._KEPT.clear()
