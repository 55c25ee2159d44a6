"""The port's host spans and counters (`yaik_tpu_torch/utils/profiler.py`).

On the CPU: off, a stage or a count records nothing; nested spans get
their parent and call ids; the planner threads of `decode_corpus` and the
zstd pool of `_ZstdBatch.run` record spans under the span that handed them
the work, with the names and counts of a single-threaded run; self time is
a span's duration less the union of its children; one `decode_image` of
img64 counts exactly its packed operands up and its pixels down.

On the card (marker `cuda`), the spans' clock against the profiler's
device events, and the transfer counters against the profiler's memcpy
bytes. This file imports no jax:

    python -m pytest tests/test_torch_profiler.py -q -m cuda --noconftest
"""
import json
import pathlib
import statistics
import threading

import numpy as np
import pytest
import torch

import yaik_tpu_torch
from yaik_tpu_torch.decoder import pack
from yaik_tpu_torch.decoder import planner as plannermod
from yaik_tpu_torch.encoder import context as ectx
from yaik_tpu_torch.parallel.batch import decode_corpus
from yaik_tpu_torch.utils import profiler
from yaik_tpu_torch.utils.profiler import Span

FIX = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def bank():
    return yaik_tpu_torch.assign_lut((FIX / "LutFile.lut").read_bytes())


def _by_name(prof) -> dict:
    out: dict = {}
    for e in prof.events:
        out.setdefault(e.name, []).append(e)
    return out


def _check_ids(prof) -> None:
    """Every span's parent was recorded and shares its call id; a root
    span's call id is its own id."""
    spans = {e.span: e for e in prof.events}
    assert len(spans) == len(prof.events)
    for e in prof.events:
        if e.parent == 0:
            assert e.call == e.span
        else:
            p = spans[e.parent]
            assert e.call == p.call
            assert p.start_ns <= e.start_ns <= e.end_ns <= p.end_ns


def _counts(prof) -> dict:
    return {k: len(v) for k, v in _by_name(prof).items()}


def test_off_records_no_span_and_no_count(bank):
    stream = (FIX / "img64.yaik").read_bytes()
    with profiler.enable() as prof:
        pass
    assert not profiler.on() and profiler.current() is None
    assert profiler.stage("a") is profiler.stage("b")      # one shared no-op
    with profiler.stage("a"):
        assert profiler.current() is None
    profiler.count("h2d_bytes", 7)
    yaik_tpu_torch.decode_image(stream, bank, device="cpu")
    assert prof.events == [] and prof.counters == {}
    assert profiler._active is None


def test_nested_spans_get_parent_and_call_ids():
    with profiler.enable() as prof:
        with profiler.stage("a"):
            with profiler.stage("b"):
                with profiler.stage("c"):
                    here = profiler.current()
            with profiler.stage("d"):
                pass
        with profiler.stage("e"):
            pass
        assert profiler.current() is None
    ev = {e.name: e for e in prof.events}
    assert [e.name for e in prof.events] == ["c", "b", "d", "a", "e"]
    a, b, c, d, e = (ev[k] for k in "abcde")
    assert here == (a.span, c.span)
    assert (a.parent, b.parent, c.parent, d.parent) == (0, a.span, b.span,
                                                         a.span)
    assert {a.call, b.call, c.call, d.call} == {a.span}
    assert e.parent == 0 and e.call == e.span != a.span
    assert {x.thread for x in prof.events} == {threading.get_ident()}
    _check_ids(prof)


def test_parent_handed_to_another_thread():
    with profiler.enable() as prof:
        with profiler.stage("submit"):
            here = profiler.current()

            def work():
                with profiler.stage("job", parent=here):
                    with profiler.stage("inner"):
                        profiler.count("n", 2)
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=60)
            assert not t.is_alive()
        profiler.count("n", 1)
    ev = {e.name: e for e in prof.events}
    assert ev["job"].parent == ev["submit"].span
    assert ev["inner"].parent == ev["job"].span
    assert ev["job"].thread == ev["inner"].thread != ev["submit"].thread
    assert {e.call for e in prof.events} == {ev["submit"].span}
    assert prof.counters == {"n": 3}
    _check_ids(prof)


def test_decode_corpus_planner_threads(bank):
    """Planner threads record each stream's plan and pack under the
    corpus's root span; the names and counts equal a one-thread run's, and
    so do the pixels."""
    names = ["img64", "img128", "img64", "quilt128", "img128", "img64"]
    streams = [(FIX / f"{n}.yaik").read_bytes() for n in names]
    decode_corpus(streams[:1], bank, device="cpu")         # the tables
    runs = {}
    for workers in (1, 2):
        with profiler.enable() as prof:
            out = decode_corpus(streams, bank, batch_size=2,
                                planner_workers=workers, device="cpu")
        runs[workers] = (prof, out)
        _check_ids(prof)
        root, = _by_name(prof)["decode:corpus"]
        assert {e.call for e in prof.events} == {root.span}
        for job in _by_name(prof)["decode:plan-pack"]:
            assert job.parent == root.span
        threads = {e.thread for e in _by_name(prof)["decode:plan-pack"]}
        assert (threading.get_ident() in threads) == (workers == 1)
        assert len(_by_name(prof)["decode:pack"]) >= len(streams)
    (one, a), (two, b) = runs[1], runs[2]
    assert _counts(one) == _counts(two)
    assert one.counters == two.counters
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_zstd_pool_jobs_under_the_flush():
    rng = np.random.default_rng(5)
    datas = [bytes(rng.integers(0, 4, n, dtype=np.uint8))
             for n in (3000, 20000, 500, 9000, 12000, 700)]
    runs = {}
    for workers in (0, 3):
        zb = ectx._ZstdBatch()
        for d in datas:
            zb.add(d, 18)
        with profiler.enable() as prof:
            with profiler.stage("encode:zstd-flush"):
                zb.run(workers)
        runs[workers] = prof
        _check_ids(prof)
        flush, = _by_name(prof)["encode:zstd-flush"]
        jobs = _by_name(prof)["zstd:job"]
        assert len(jobs) == len(datas)
        assert {j.parent for j in jobs} == {flush.span}
        assert {j.call for j in jobs} == {flush.span}
        on_caller = {j.thread for j in jobs} == {threading.get_ident()}
        assert on_caller == (workers == 0)
        assert prof.counters == {
            "zstd_in_bytes": sum(map(len, datas)),
            "zstd_out_bytes": sum(len(zb.get(i)) for i in range(len(datas)))}
    assert _counts(runs[0]) == _counts(runs[3])
    root0, root3 = runs[0].root, runs[3].root
    assert list(root0.children) == list(root3.children) == [
        "encode:zstd-flush"]
    assert list(root3.children["encode:zstd-flush"].children) == ["zstd:job"]


def test_self_time_is_duration_less_the_union_of_children():
    p = profiler.Profile()
    p.t0, p.t1 = 0, 1000
    p.events = [Span("outer", 1, 1, 0, 1, 100, 200),
                Span("kid", 1, 2, 1, 2, 110, 130),
                Span("kid", 1, 3, 1, 3, 120, 150),     # overlaps the first
                Span("kid", 1, 4, 1, 3, 190, 260),     # past the parent
                Span("grand", 1, 5, 4, 3, 195, 196),
                Span("other", 6, 6, 0, 1, 500, 600)]
    root = p.root
    outer = root.children["outer"]
    ns = pytest.approx
    assert outer.count == 1 and outer.total == ns(100e-9)
    assert outer.self_s == ns((100 - 40 - 10) * 1e-9)
    kid = outer.children["kid"]
    assert kid.count == 3 and kid.total == ns((20 + 30 + 70) * 1e-9)
    assert kid.self_s == ns((20 + 30 + 69) * 1e-9)
    assert root.total == ns(1000e-9) and root.self_s == ns(800e-9)
    lines = profiler.report(p).splitlines()
    assert [ln.split()[0] for ln in lines] == ["total", "outer", "kid",
                                               "grand", "other"]


def test_transfer_counters_of_one_cpu_decode(bank):
    stream = (FIX / "img64.yaik").read_bytes()
    want = yaik_tpu_torch.decode_image(stream, bank, device="cpu")  # tables
    plan = plannermod.build_plan(stream, bank.expanded, bank.expanded2d)
    tabs = pack.lut_table(bank.expanded)
    sizes = []
    pack.map_arrays(pack.plan_to_args(plan, tabs),
                    lambda a: sizes.append(a.nbytes) or a)
    with profiler.enable() as prof:
        got = yaik_tpu_torch.decode_image(stream, bank, device="cpu")
    assert np.array_equal(got, want)
    assert prof.counters == {"h2d_bytes": sum(sizes),
                             "h2d_copies": len(sizes),
                             "d2h_bytes": 64 * 64 * 3, "d2h_copies": 1}


# -- on the card --------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _device_events(prof) -> list:
    """(name, start ns, end ns) of the profiler's device events."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if str(e.device_type()).endswith("CUDA")]


def _sleeps(prof) -> list:
    """(name, start ns, end ns) of the `torch.cuda._sleep` kernels (ATen's
    `spin_kernel`) among the profiler's device events."""
    return [e for e in _device_events(prof)
            if "spin_kernel" in e[0] or "sleep" in e[0].lower()]


@pytest.mark.cuda
def test_spans_share_the_device_events_clock(cuda):
    """A span around `torch.cuda._sleep` and a synchronize encloses the
    sleep kernel's event, within 0.5 ms at each end, in 19 of 20 trials;
    and in the median trial the span ends within 0.5 ms after the kernel
    (the synchronize returns as it ends). A clock offset shows at either
    end; the kernel starts after the span by its launch (0.03-0.6 ms under
    the profiler on an H100), and the host wakes from the synchronize late
    now and then (0.8 and 1.5 ms in 2 of 100 trials)."""
    from torch.profiler import ProfilerActivity, profile
    cycles = 10_000_000                           # ~5 ms at ~2 GHz
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize(cuda)
    good, tails, seen = 0, [], []
    for _ in range(20):
        with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                profiler.enable() as p:
            with profiler.stage("sleep"):
                torch.cuda._sleep(cycles)
                torch.cuda.synchronize(cuda)
        span, = p.events
        ks = _sleeps(prof)
        if len(ks) != 1:
            seen.append([e[0][:40] for e in _device_events(prof)])
            continue
        _, k0, k1 = ks[0]
        lead, tail = k0 - span.start_ns, span.end_ns - k1
        seen.append((lead / 1e6, tail / 1e6, (k1 - k0) / 1e6))
        good += lead >= -5e5 and tail >= -5e5
        tails.append(tail)
    print("lead ms, tail ms, kernel ms:", seen)
    assert good >= 19, seen
    assert statistics.median(tails) <= 5e5, seen


def _memcpy_bytes(prof, tmp_path) -> dict:
    """HtoD and DtoH bytes of the profiler's memcpy events (the Chrome
    trace's `bytes`)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out = {"HtoD": 0, "DtoH": 0}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") != "gpu_memcpy":
            continue
        for way in out:
            if way in e["name"]:
                out[way] += int(e["args"]["bytes"])
    return out


@pytest.mark.cuda
def test_copy_counters_account_for_the_memcpy_bytes(cuda, bank, tmp_path):
    """One decode_image of bench_4k and one encode_image of its pixels:
    the counters hold at least 99.9% of the HtoD and DtoH bytes of the
    profiler's memcpy events. Each window is bracketed by two
    `torch.cuda._sleep` markers and taken again (at most three times)
    until both are recorded: the profiler can drop a window's first
    events (a 4K encode's one HtoD copy, once in three calls on an H100)."""
    from torch.profiler import ProfilerActivity, profile
    from yaik_tpu_torch.encoder import bank as bankmod
    stream = (FIX / "bench_4k.yaik").read_bytes()
    bank3d = bankmod.load_bank(str(FIX / "Bank3D"))
    rgb = yaik_tpu_torch.decode_image(stream, bank, device=cuda)   # warm
    yaik_tpu_torch.encode_image(rgb, bank3d, device=cuda)
    torch.cuda.synchronize(cuda)
    for name, call in (
            ("decode", lambda: yaik_tpu_torch.decode_image(stream, bank,
                                                           device=cuda)),
            ("encode", lambda: yaik_tpu_torch.encode_image(rgb, bank3d,
                                                           device=cuda))):
        for _ in range(3):      # until the window's both markers recorded
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(1000)
                torch.cuda.synchronize(cuda)
                with profiler.enable() as p:
                    call()
                    torch.cuda.synchronize(cuda)
                torch.cuda._sleep(1000)
                torch.cuda.synchronize(cuda)
            if len(_sleeps(prof)) == 2:
                break
        seen = _memcpy_bytes(prof, tmp_path)
        print(name, "memcpy bytes", seen, "counters", p.counters,
              "markers", len(_sleeps(prof)))
        assert len(_sleeps(prof)) == 2
        assert seen["HtoD"] > 0 and seen["DtoH"] > 0
        assert p.counters["h2d_bytes"] >= 0.999 * seen["HtoD"], name
        assert p.counters["d2h_bytes"] >= 0.999 * seen["DtoH"], name
