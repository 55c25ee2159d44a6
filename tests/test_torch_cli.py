"""The port's command line (`python -m yaik_tpu_torch`) against the JAX
package's (`python -m yaik_tpu`) on the CPU, both run in this process.

Each subcommand of the port, with `--device cpu`, against the JAX command
line on the same inputs: `encode` (the `.yaik` bytes, the `.log.txt`, the
global-stats JSON after two runs, the printed statistics; default passes,
UCOL, 2D) against `--engine device`; `decode` of the small fixture streams
(and the fused flags, which the JAX command line reads from the
environment) against `--engine host` and the goldens; `lut` (3d, 2d);
`stats` (text and JSON) on every fixture stream but bench_4k; `mine` (3d,
2d) and `mine-report` of two 64x64 images against `--engine device`;
`roundtrip`. `--profile` names the stages of the JAX command line's
device engines (`encode --engine device`, `decode --engine jax`), each
under the same one of them (or none), and beside them exactly the port's
own spans (`ENCODE_SPANS`, `DECODE_SPANS`),
`--trace` writes a trace that parses, `YAIK_DEBUG_DUMP` writes the JAX
device engine's claim maps, and `--device cuda` without a card fails with
the device error. The subcommands, positional arguments and flags are the
JAX command line's, with `--device` added beside `--engine` and `decode`'s
`--t3-d1` / `--grad-final` added (`--engine host` is
tests/test_torch_host.py's). Tolerance is exact everywhere: bytes,
pixels, JSON and printed numbers (all but wall times).

On the card, chip_smoke.py drives the same command line at full width.
"""
import contextlib
import io
import json
import os
import re
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import yaik_tpu.__main__ as jax_cli
import yaik_tpu_torch.__main__ as port_cli
from yaik_tpu_torch.utils import profiler

FIX = port_cli.DEFAULT_FIX
STREAMS = sorted(p.name[:-5] for p in FIX.glob("*.yaik")
                 if p.name != "bench_4k.yaik")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while these tests run: the suite runs several
    workers on the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_main(argv: list) -> None:
    """`python -m yaik_tpu <argv>` in this process."""
    saved = sys.argv
    sys.argv = ["yaik_tpu", *argv]
    try:
        jax_cli.main()
    finally:
        sys.argv = saved


MAINS = {"jax": jax_main, "port": port_cli.main}


def _runner(name):
    def run(*argv) -> str:
        """The command line's standard output for `argv`."""
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            MAINS[name]([str(a) for a in argv])
        return out.getvalue()
    return run


jax_run, port_run = _runner("jax"), _runner("port")
CLIS = {"jax": jax_run, "port": port_run}


def untimed(text: str) -> str:
    """Output with the wall times taken out (" in 1.23s")."""
    return re.sub(r" in \d+\.\d+s", " in Ts", text)


# The port's spans beside the JAX package's stages (README, `--profile`).
ENCODE_SPANS = {"encode:image", "encode:upload", "encode:gradient-scoring",
                "encode:download", "zstd:job"}
DECODE_SPANS = {"decode:image", "decode:pack", "pack:gradient", "pack:t3",
                "pack:2dtl", "pack:d1", "pack:extras", "decode:upload",
                "decode:dispatch", "decode:download"}


def _stage_lines(text: str) -> list:
    """(depth, name) of each stage line of the `--profile` report that
    ends `text` (the lines below `total`, up to the counters)."""
    lines = text.splitlines()
    start = next(i for i, l in enumerate(lines) if l.startswith("total "))
    out = []
    for line in lines[start + 1:]:
        if not line.strip():
            break
        out.append(((len(line) - len(line.lstrip())) // 2, line.split()[0]))
    return out


def stage_names(text: str) -> set:
    """The stage names of the `--profile` report that ends `text`."""
    return {name for _, name in _stage_lines(text)}


def stage_parents(text: str, among: set) -> set:
    """(stage, its nearest enclosing stage of `among`, or "total") for each
    stage of `among` in the report that ends `text`."""
    path, out = [], set()
    for depth, name in _stage_lines(text):
        del path[depth - 1:]
        if name in among:
            out.add((name, next((p for p in reversed(path) if p in among),
                                "total")))
        path.append(name)
    return out


def pixels(path) -> np.ndarray:
    return np.asarray(Image.open(path))


def _in(path, monkeypatch):
    path.mkdir(parents=True, exist_ok=True)
    monkeypatch.chdir(path)


# -- encode -------------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--enable-single-color"],
                                   ["--enable-2d"]],
                         ids=["default", "single-color", "2d"])
def test_encode_equals_the_jax_cli(flags, tmp_path, monkeypatch):
    """Bytes, .log.txt, printed statistics, the global statistics after
    two runs and the stage names of `--profile`."""
    got = {}
    for name, engine in (("jax", ["--engine", "device"]),
                         ("port", ["--device", "cpu"])):
        _in(tmp_path / name, monkeypatch)
        args = ["encode", FIX / "img64.png", "img64.yaik", *engine, *flags,
                "--stats", "--global-stats", "global.json"]
        first = CLIS[name](*args, "--profile")
        second = CLIS[name](*args)
        got[name] = {"stream": (tmp_path / name / "img64.yaik").read_bytes(),
                     "log": (tmp_path / name / "img64.yaik.log.txt"
                             ).read_text(),
                     "global": (tmp_path / name / "global.json").read_text(),
                     "first": untimed(first), "second": untimed(second),
                     "stages": stage_names(first)}
    jax, port = got["jax"], got["port"]
    assert port["stream"] == jax["stream"] and port["stream"][:4] == b"YAIK"
    assert port["log"] == jax["log"] and "claimed total" in port["log"]
    assert json.loads(port["global"])["images"] == 2
    assert port["global"] == jax["global"]
    assert port["stages"] == jax["stages"] | ENCODE_SPANS
    assert not jax["stages"] & ENCODE_SPANS
    assert stage_parents(port["first"], jax["stages"]) == \
        stage_parents(jax["first"], jax["stages"])
    assert "\ncounters\n" in port["first"]
    assert {"encode:3d-scoring", "encode:gradient",
            "encode:zstd-flush"} <= port["stages"]
    assert ("encode:2d-scoring" in port["stages"]) == ("--enable-2d" in flags)
    # the printed lines but the profile's times, which differ
    cut = port["first"].index("\ntotal ")
    assert port["first"][:cut] == jax["first"][:jax["first"].index("\ntotal ")]
    assert port["second"] == jax["second"]
    assert "\ntotal " not in port["second"]


def test_stage_is_a_no_op_when_profiling_is_off():
    with profiler.enable() as prof:
        with profiler.stage("decode:plan"), profiler.stage("inner"):
            pass
    with profiler.stage("decode:plan"):
        assert profiler._active is None
    profiler.count("h2d_bytes", 1)
    assert len(prof.events) == 2 and not prof.counters  # nothing recorded
    assert stage_names(profiler.report(prof)) == {"decode:plan", "inner"}


def test_trace_on_the_cpu(tmp_path):
    port_run("encode", FIX / "img64.png", tmp_path / "a.yaik", "--device",
             "cpu", "--trace", tmp_path / "tb")
    trace = json.loads((tmp_path / "tb" / "trace.json").read_text())
    ops = [e for e in trace["traceEvents"] if e.get("cat") == "cpu_op"]
    assert ops and not profiler.kernel_events(trace)
    assert (tmp_path / "a.yaik").read_bytes()[:4] == b"YAIK"


def test_debug_dump_equals_the_jax_device_engine(tmp_path, monkeypatch):
    """YAIK_DEBUG_DUMP: the claim maps after the gradient and the 3D
    passes, by name and by pixel."""
    for name, engine in (("jax", ["--engine", "device"]),
                         ("port", ["--device", "cpu"])):
        monkeypatch.setenv("YAIK_DEBUG_DUMP", str(tmp_path / name))
        CLIS[name]("encode", FIX / "img64.png", tmp_path / f"{name}.yaik",
                   *engine)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["enc_gradient_claims4_accept.png",
                     "enc_tile3d_claims4_accept.png"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        a, b = pixels(tmp_path / "port" / n), pixels(tmp_path / "jax" / n)
        assert a.shape == (16, 16) and np.array_equal(a, b)
    assert 0 < pixels(tmp_path / "port" / names[0]).sum()


# -- decode -------------------------------------------------------------------

DECODES = {"img64": [], "img128": [], "quilt128": [],
           "alpha64_8bit.rgba": [], "img64.ucol": [],
           "corr2d128.2d": ["--lut2d", FIX / "LutFile2D.lut"]}


@pytest.mark.parametrize("name,fused", [(n, False) for n in DECODES]
                         + [("img64", True), ("img128", True)])
def test_decode_equals_the_jax_cli(name, fused, tmp_path):
    """Pixels against `decode --engine host` and the golden; the fused
    flags (the JAX package's YAIK_T3_D1 / YAIK_GRAD_FINAL) change none."""
    stream = FIX / f"{name}.yaik"
    extra = DECODES[name] + (["--t3-d1", "--grad-final"] if fused else [])
    jax_out = jax_run("decode", stream, tmp_path / "jax.png", "--engine",
                      "host", *DECODES[name])
    port_out = port_run("decode", stream, tmp_path / "port.png", "--device",
                        "cpu", *extra)
    want = pixels(tmp_path / "jax.png")
    got = pixels(tmp_path / "port.png")
    assert got.shape == want.shape and np.array_equal(got, want)
    assert got.shape[2] == (4 if name.endswith(".rgba") else 3)
    golden = FIX / f"{name}.dec.npz"
    if golden.exists():
        assert np.array_equal(got, np.load(golden)["rgb"])
    assert port_out.split(" in ")[0] == jax_out.split(" in ")[0]


def test_decode_profile_names_the_jax_engines_stages(tmp_path):
    stream = FIX / "img64.yaik"
    jax_out = jax_run("decode", stream, tmp_path / "j.png", "--engine",
                      "jax", "--profile")
    port_out = port_run("decode", stream, tmp_path / "p.png", "--device",
                        "cpu", "--profile")
    want = stage_names(jax_out)
    assert want == {"decode:plan", "decode:pack-args", "decode:device"}
    assert stage_names(port_out) == want | DECODE_SPANS
    assert stage_parents(port_out, want) == stage_parents(jax_out, want)
    assert "\ncounters\n" in port_out


# -- lut, stats ---------------------------------------------------------------

@pytest.mark.parametrize("mode", ["3d", "2d"])
def test_lut_equals_the_jax_cli(mode, tmp_path, monkeypatch):
    bank = FIX / ("Bank3D" if mode == "3d" else "Bank2D")
    out = {}
    for name in CLIS:
        _in(tmp_path / name, monkeypatch)
        out[name] = CLIS[name]("lut", bank, "out.lut", "--mode", mode)
    assert out["port"] == out["jax"]
    data = (tmp_path / "port" / "out.lut").read_bytes()
    assert data == (tmp_path / "jax" / "out.lut").read_bytes()
    if mode == "3d":
        assert data == (FIX / "LutFile.lut").read_bytes()


@pytest.mark.parametrize("fmt", [[], ["--json"]], ids=["text", "json"])
@pytest.mark.parametrize("name", STREAMS)
def test_stats_equals_the_jax_cli(name, fmt):
    args = ["stats", FIX / f"{name}.yaik", *fmt]
    out = port_run(*args)
    assert out == jax_run(*args) and out.strip()


# -- mine, mine-report, roundtrip --------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two 64x64 PNGs: img64 and a copy rolled by a tile and mirrored."""
    d = tmp_path_factory.mktemp("corpus")
    img = pixels(FIX / "img64.png")
    Image.fromarray(np.ascontiguousarray(
        np.roll(np.roll(img, 8, 1), 8, 0)[:, ::-1])).save(d / "v64.png")
    return [FIX / "img64.png", d / "v64.png"]


def _files(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("mode", ["3d", "2d"])
def test_mine_equals_the_jax_cli(mode, corpus, tmp_path, monkeypatch):
    out = {}
    for name, engine in (("jax", ["--engine", "device"]),
                         ("port", ["--device", "cpu"])):
        _in(tmp_path / name, monkeypatch)
        out[name] = CLIS[name]("mine", "bank", *corpus, "--mode", mode,
                               *engine)
    assert out["port"] == out["jax"] and out["port"].startswith(
        tuple("123456789"))
    files = _files(tmp_path / "port" / "bank")
    assert files and files == _files(tmp_path / "jax" / "bank")


def test_mine_report_equals_the_jax_cli(corpus, tmp_path, monkeypatch):
    """The mined files, the report JSON (bpp and PSNR included) and the
    printed lines."""
    out = {}
    for name, engine in (("jax", ["--engine", "device"]),
                         ("port", ["--device", "cpu"])):
        _in(tmp_path / name, monkeypatch)
        out[name] = CLIS[name]("mine-report", "mined", *corpus, "--report",
                               "report.json", *engine)
    assert out["port"] == out["jax"]
    report = (tmp_path / "port" / "report.json").read_text()
    assert report == (tmp_path / "jax" / "report.json").read_text()
    banks = json.loads(report)["banks"]
    assert banks["baseline"]["psnr_db"] > 30 and banks["mined"]["bpp"] > 0
    files = _files(tmp_path / "port" / "mined")
    assert files and files == _files(tmp_path / "jax" / "mined")


def test_roundtrip_equals_the_jax_cli():
    img = FIX / "img64.png"
    line = port_run("roundtrip", img, "--device", "cpu")
    assert line == jax_run("roundtrip", img, "--engine", "device")
    assert "PSNR" in line


# -- the card, and the surface ------------------------------------------------

@pytest.mark.parametrize("args", [
    ["encode", FIX / "img64.png", "out.yaik"],
    ["encode", FIX / "img64.png", "out.yaik", "--trace", "tb"],
    ["decode", FIX / "img64.yaik", "out.png"],
    ["roundtrip", FIX / "img64.png"],
    ["mine", "bank", FIX / "img64.png"],
    ["mine-report", "mined", FIX / "img64.png"]],
    ids=["encode", "encode-trace", "decode", "roundtrip", "mine",
         "mine-report"])
def test_the_card_is_the_default_and_never_falls_back(args, tmp_path,
                                                      monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        port_run(*args)
    assert not os.path.exists("out.yaik") and not os.path.exists("tb")


def _surface(name: str, cmd=None) -> tuple:
    """(flags, positionals) of a command line's usage, from its --help."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        MAINS[name]([*([cmd] if cmd else []), "--help"])
    usage = out.getvalue().split("\n\n")[0]
    flags = set(re.findall(r"(?<![\w-])(--[a-z0-9][a-z0-9-]*)", usage))
    while re.search(r"\[[^\[\]]*\]", usage):
        usage = re.sub(r"\[[^\[\]]*\]", "", usage)
    return flags, usage.split()[2 + bool(cmd):]


def test_the_surface_is_the_jax_cli_with_devices():
    (_, jax_cmds), (_, port_cmds) = _surface("jax"), _surface("port")
    assert port_cmds == jax_cmds == [
        "{encode,decode,lut,mine,stats,mine-report,roundtrip}", "..."]
    for cmd in jax_cmds[0][1:-1].split(","):
        jflags, jpos = _surface("jax", cmd)
        pflags, ppos = _surface("port", cmd)
        added = {"--t3-d1", "--grad-final"} if cmd == "decode" else set()
        if "--engine" in jflags:
            added.add("--device")
        assert ppos == jpos and jpos, cmd
        assert pflags == jflags | added, cmd
