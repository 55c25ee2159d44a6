"""The port carries its own host code, and the reference values chip_smoke.py
reads stay current.

yaik_tpu_torch keeps its own copies of the JAX package's framework-neutral
host modules (format/, entropy/, native/, the decode planner and the host
decoder it reads, the host half of alpha, the encoder's bank (with its
nearest-point maps) and emission, the host 3D scorer's pattern tables, and
the encoder's host passes: alpha.py, single_color.py, smooth_map.py,
ops/plane.py, the gradient host scorer, bank2d.py, corr2d.py and plnt.py).
These tests hold each copy equal to its original on the fixtures, field by
field, and check that no file of the port, chip_smoke.py or a tests/ helper
it imports names the JAX package or jax. tests/test_torch_host.py holds
the host engines, the C library and the analyzers.

chip_smoke.py runs without the JAX package, so its reference values are
made here once, on the CPU, by the JAX package, and committed:
- tests/fixtures/port_digests.json: the sha256 of `reference.decode`'s
  pixels for every stream chip_smoke decodes that has no `.dec.npz`
  golden, and of `reference.decode(host encode(png))` for the images it
  encodes (tile choices fix the pixels, whatever zstd compressed them);
- the RGBA streams it decodes, as tests/fixtures/<name>.rgba.yaik, encoded
  by the JAX package's host engine.
`test_digest_is_current` and `test_rgba_fixture_is_current` recompute each
one with the JAX package. To write them anew (after a change to the codec):

    JAX_PLATFORMS=cpu python tests/test_torch_selfcontained.py

Exact comparisons only: plans, tables and pixels are integers.
"""
import ast
import dataclasses
import json
import os
import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIX = ROOT / "tests" / "fixtures"
DIGESTS = FIX / "port_digests.json"
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT))

from torch_streams import (ALPHA_CASES, craft_t3_stream, digest,  # noqa: E402
                           rgba_case)

# the RGBA streams chip_smoke decodes: name -> (image, EncoderConfig keywords)
RGBA = {**{f"alpha64_{n}": (lambda n=n: rgba_case(n), ALPHA_CASES[n][0])
           for n in sorted(ALPHA_CASES)},
        "sprite256": (lambda: _png("sprite256"), {}),
        "sprite256_6bit": (lambda: _png("sprite256"),
                           dict(alpha_force_8bit=False, enable_mipmap=False))}
# streams chip_smoke decodes without a .dec.npz golden
DECODED = (["bench_4k", "corr2d128.2d", "img64.ucol", "img512.ucol",
            "gradpair192.gp", "crafted_3layer"] + sorted(RGBA))
# images chip_smoke encodes: digest of the host engine's stream, decoded
ENCODED = ["img64", "img128", "quilt128", "img512"]
# every committed stream, the RGBA ones above included
STREAMS = sorted(p.name[:-5] for p in FIX.glob("*.yaik"))


def _png(name):
    from PIL import Image
    return np.asarray(Image.open(FIX / f"{name}.png"))


def stream_of(name: str) -> bytes:
    """A decode entry's stream: a committed fixture, or the crafted 3-layer
    stream tests/torch_streams.py builds."""
    if name == "crafted_3layer":
        return craft_t3_stream(64, 64, True)
    suffix = ".rgba.yaik" if name in RGBA else ".yaik"
    return (FIX / f"{name}{suffix}").read_bytes()


def _jax_bank():
    from yaik_tpu.decoder.api import assign_lut
    return assign_lut((FIX / "LutFile.lut").read_bytes(),
                      (FIX / "LutFile2D.lut").read_bytes())


def _host_encode(img, **config):
    from yaik_tpu.encoder import bank as bankmod
    from yaik_tpu.encoder.context import EncoderConfig, encode_image
    return encode_image(img, bankmod.load_bank(str(FIX / "Bank3D")),
                        EncoderConfig(**config), engine="host")


def reference_pixels(kind: str, name: str, bank) -> np.ndarray:
    """What the JAX package's host decoder makes of a digest entry."""
    from yaik_tpu.decoder import reference
    stream = (_host_encode(_png(name)) if kind == "encode"
              else stream_of(name))
    return reference.decode(stream, bank.expanded, bank.expanded2d)


def write_reference_values() -> None:
    """Encode the RGBA fixtures and write port_digests.json anew."""
    for name, (img, config) in RGBA.items():
        (FIX / f"{name}.rgba.yaik").write_bytes(_host_encode(img(), **config))
    bank = _jax_bank()
    out = {"decode": {n: digest(reference_pixels("decode", n, bank))
                      for n in DECODED},
           "encode": {n: digest(reference_pixels("encode", n, bank))
                      for n in ENCODED}}
    DIGESTS.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")


# -- no file of the port names the JAX package --------------------------------

def _imports(path: pathlib.Path) -> set:
    """Top-level-qualified names of every module `path` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _forbidden(name: str) -> bool:
    return any(name == m or name.startswith(m + ".")
               for m in ("yaik_tpu", "jax"))


def test_no_port_file_imports_the_jax_package():
    """No module of yaik_tpu_torch, nor chip_smoke.py, nor a tests/ helper
    chip_smoke.py imports (directly or through another helper), imports
    yaik_tpu (or jax), at any depth of the file (function-level imports
    included)."""
    files = sorted((ROOT / "yaik_tpu_torch").rglob("*.py"))
    smoke = ROOT / "chip_smoke.py"
    helpers, todo = [], [smoke]
    while todo:
        for n in _imports(todo.pop()):
            path = ROOT / "tests" / f"{n}.py"
            if path.exists() and path not in helpers:
                helpers.append(path)
                todo.append(path)
    assert sorted(h.name for h in helpers) == [
        "torch_covers.py", "torch_streams.py", "torch_time_covers.py",
        "torch_time_grad_score.py"]
    names = {str(f.relative_to(ROOT / "yaik_tpu_torch")) for f in files}
    assert {"__main__.py", "utils/profiler.py", "utils/stats.py",
            "utils/debug_dump.py", "decoder/reference.py",
            "encoder/corr3d.py", "encoder/analysis.py", "ops/segments.py",
            "native/capi.py"} <= names
    assert "decoder/chunks.py" not in names
    for path in files + [smoke] + helpers:
        bad = sorted(n for n in _imports(path) if _forbidden(n))
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# -- the copies equal the originals -------------------------------------------

# plan arrays the planner leaves unwritten (np.empty) where a mask is off:
# (class, field) -> the mask of their written entries
_GATED = {("Tile3DPassPlan", "colors"): lambda p: p.accept.reshape(-1),
          ("Plan1D", "indices"): lambda p: p.wmask}


def _assert_same(a, b, where):
    """Two plan objects hold equal values, recursively: numpy arrays by
    dtype and value (only where written, for the _GATED fields),
    dataclasses field by field."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            gate = _GATED.get((type(a).__name__, f.name))
            if gate is not None:
                _assert_same(gate(a), gate(b), f"{where}.{f.name} mask")
                x, y = x[gate(a)], y[gate(b)]
            _assert_same(x, y, f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    else:
        assert a == b, where


@pytest.fixture(scope="module")
def banks():
    import yaik_tpu_torch
    return yaik_tpu_torch.assign_lut((FIX / "LutFile.lut").read_bytes(),
                                     (FIX / "LutFile2D.lut").read_bytes()), \
        _jax_bank()


def test_lut_bank_equals_the_jax_package(banks):
    port, jax_bank = banks
    for f in ("tables", "expanded", "tables2d", "expanded2d"):
        _assert_same(getattr(port, f), getattr(jax_bank, f), f)


@pytest.mark.parametrize("name", STREAMS + ["crafted_3layer"])
def test_plan_equals_the_jax_package(name, banks):
    """decoder/planner.py (with reference.py, alpha.py's host half, format/,
    entropy/ and native/) builds the JAX package's plan, field by field,
    the alpha channel included."""
    from yaik_tpu.decoder import planner as jplanner
    from yaik_tpu_torch.decoder import planner
    port, jax_bank = banks
    stream = (craft_t3_stream(64, 64, True) if name == "crafted_3layer"
              else (FIX / f"{name}.yaik").read_bytes())
    got = planner.build_plan(stream, port.expanded, port.expanded2d)
    want = jplanner.build_plan(stream, jax_bank.expanded, jax_bank.expanded2d)
    _assert_same(got, want, name)
    if want.has_alpha:
        _assert_same(got.host_alpha(), want.host_alpha(), "alpha")


@pytest.mark.parametrize("name", sorted(RGBA))
def test_alpha_host_half_equals_the_jax_package(name):
    """decode_mipm / decode_alpm, the chunk-level host decoders the plan's
    alpha replaces, equal the originals on every RGBA fixture."""
    from yaik_tpu.decoder import alpha as jalpha
    from yaik_tpu_torch.decoder import alpha
    from yaik_tpu_torch.decoder.reference import iter_chunks
    from yaik_tpu_torch.format.headers import FileHeader
    stream = stream_of(name)
    fh = FileHeader.unpack(stream)
    mip = jmip = (None, None)
    seen = set()
    for tag, _, body in iter_chunks(stream):
        seen.add(tag)
        if tag == b"MIPM":
            mip = alpha.decode_mipm(body, fh.width, fh.height)
            jmip = jalpha.decode_mipm(body, fh.width, fh.height)
            _assert_same(mip, jmip, "mipm")
        elif tag == b"ALPM":
            _assert_same(alpha.decode_alpm(body, fh.width, fh.height, *mip),
                         jalpha.decode_alpm(body, fh.width, fh.height, *jmip),
                         "alpm")
    assert b"ALPM" in seen or name.endswith("const255")


@pytest.mark.parametrize("name", ["img64", "img64.ucol", "bench_rgba512",
                                  "corr2d128.2d"])
def test_pure_python_fallbacks_equal_the_host_library(name, banks,
                                                      monkeypatch):
    """Without the host library (native.available() False) the planner's
    pure-Python twins build the same plan, and the encoder's the same bytes
    (img64)."""
    from PIL import Image

    import yaik_tpu_torch
    from yaik_tpu_torch import native
    from yaik_tpu_torch.decoder import planner
    from yaik_tpu_torch.encoder import bank as bankmod
    port = banks[0]
    stream = (FIX / f"{name}.yaik").read_bytes()
    img = np.asarray(Image.open(FIX / "img64.png"))
    bank3d = bankmod.load_bank(str(FIX / "Bank3D"))
    assert native.available()
    want = planner.build_plan(stream, port.expanded, port.expanded2d)
    want_bytes = yaik_tpu_torch.encode_image(img, bank3d, "cpu")
    monkeypatch.setattr(native, "available", lambda: False)
    _assert_same(planner.build_plan(stream, port.expanded, port.expanded2d),
                 want, name)
    if name == "img64":
        assert yaik_tpu_torch.encode_image(img, bank3d, "cpu") == want_bytes


def test_encoder_bank_and_perms_equal_the_jax_package():
    from yaik_tpu.encoder import bank as jbankmod
    from yaik_tpu.encoder.corr3d import PERMS48 as JPERMS48
    from yaik_tpu.encoder.corr3d import SWAP3D as JSWAP3D
    from yaik_tpu_torch.encoder import bank as bankmod, corr3d, tables
    got = bankmod.load_bank(str(FIX / "Bank3D"))
    want = jbankmod.load_bank(str(FIX / "Bank3D"))
    assert got.count == want.count and len(got.ctxs) == len(want.ctxs)
    for f in dataclasses.fields(got):
        if f.name != "ctxs":
            _assert_same(getattr(got, f.name), getattr(want, f.name), f.name)
    for i, (a, b) in enumerate(zip(got.ctxs, want.ctxs)):
        _assert_same(a.factors, b.factors, f"ctxs[{i}].factors")
    # one copy of the pattern permutations, the scoring tables' too
    assert tables.PERMS48 is corr3d.PERMS48
    assert [tuple(p) for p in corr3d.PERMS48] == \
        [tuple(p) for p in JPERMS48]
    assert corr3d.SWAP3D == JSWAP3D


@pytest.mark.parametrize("index", range(12))
def test_eval_ctx_maps_equal_the_jax_package(index):
    """Each Bank3D file's nearest-point index maps and distance field,
    built when first read, equal the ones the JAX package builds at
    load; load_bank itself builds none."""
    from yaik_tpu.encoder import bank as jbankmod
    from yaik_tpu_torch.encoder import bank as bankmod
    name = bankmod.BANK_FILE_NAMES[index]
    pts = bankmod.load_bank_file(str(FIX / "Bank3D" / name))
    assert pts is not None
    got = bankmod.build_eval_ctx(pts)
    assert got.maps is None
    want = jbankmod.build_eval_ctx(pts)
    _assert_same(got.factors, want.factors, "factors")
    _assert_same(got.position, want.position, "position")
    _assert_same(got.dist_field, want.dist_field, "dist_field")
    assert got.maps is not None


def test_write_lut_file_equals_the_jax_package(banks):
    """The LutFile.lut writer on Bank3D (the committed LutFile.lut) and on
    a bank of its first five tables."""
    from yaik_tpu.encoder import bank as jbankmod
    from yaik_tpu_torch.encoder import bank as bankmod
    got = bankmod.load_bank(str(FIX / "Bank3D"))
    want = jbankmod.load_bank(str(FIX / "Bank3D"))
    assert bankmod.write_lut_file(got) == jbankmod.write_lut_file(want) \
        == (FIX / "LutFile.lut").read_bytes()
    part = (bankmod.Bank(got.ctxs[:5], got.points[:5]),
            jbankmod.Bank(want.ctxs[:5], want.points[:5]))
    assert bankmod.write_lut_file(part[0]) == jbankmod.write_lut_file(part[1])


@pytest.mark.parametrize("name", [n for n in STREAMS if n != "bench_4k"])
def test_stats_copy_equals_the_jax_package(name, tmp_path):
    """`analyze` (with its dummy tables, and with the LUT file) and
    `accumulate_global` over two streams."""
    from yaik_tpu.utils import stats as jstats
    from yaik_tpu_torch.utils import stats
    suffix = ".rgba.yaik" if name in RGBA else ".yaik"
    stream = (FIX / f"{name}{suffix}").read_bytes()
    lut = (FIX / "LutFile.lut").read_bytes()
    for args in ((stream,), (stream, lut)):
        got, want = stats.analyze(*args), jstats.analyze(*args)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.to_json() == want.to_json()
        assert got.summary() == want.summary()
    other = stats.analyze((FIX / "img64.yaik").read_bytes())
    for mod, d in ((stats, "port"), (jstats, "jax")):
        path = str(tmp_path / f"{d}.json")
        for st in (mod.analyze(stream), other):
            mod.accumulate_global(path, st)
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()


def test_stage_timers_equal_the_jax_package(monkeypatch):
    """The same nested stages on the same (counting) clock give the same
    report: each line's stage, depth, total, count and share (the port's
    report adds each stage's self time)."""
    from yaik_tpu.utils import profiler as jprofiler
    from yaik_tpu_torch.utils import profiler
    reports = []
    for mod, clock_name, unit in ((profiler, "now_ns", 1_000_000),
                                  (jprofiler, "perf_counter", 1e-3)):
        clock = iter(range(0, 10_000, 7))
        owner = mod if clock_name == "now_ns" else mod.time
        monkeypatch.setattr(owner, clock_name, lambda: next(clock) * unit)
        with mod.enable() as prof:
            for _ in range(2):
                with mod.stage("decode:plan"):
                    with mod.stage("inner"):
                        pass
            with mod.stage("decode:device"):
                pass
        with mod.stage("off"):          # profiling is off again
            pass
        reports.append(mod.report(prof))
        monkeypatch.undo()

    def lines(report):
        return [(len(l) - len(l.lstrip()), l.split()[0], l.split()[1],
                 next(t for t in l.split() if t.startswith("x")),
                 l.split()[-1]) for l in report.splitlines()]
    assert lines(reports[0]) == lines(reports[1])
    assert [l.split()[0] for l in reports[0].splitlines()] == [
        "total", "decode:plan", "inner", "decode:device"]


def test_debug_dump_copy_equals_the_jax_package(tmp_path, monkeypatch):
    from yaik_tpu.utils import debug_dump as jdump
    from yaik_tpu_torch.utils import debug_dump
    accept = np.random.default_rng(3).random((16, 24)) < 0.4
    monkeypatch.delenv("YAIK_DEBUG_DUMP", raising=False)
    assert not debug_dump.enabled() and not jdump.enabled()
    debug_dump.snapshot_accepts("off", accept)
    assert not list(tmp_path.iterdir())
    for mod, d in ((debug_dump, "port"), (jdump, "jax")):
        monkeypatch.setenv("YAIK_DEBUG_DUMP", str(tmp_path / d))
        assert mod.enabled()
        mod.snapshot_accepts("gradient_claims4", accept)
    name = "enc_gradient_claims4_accept.png"
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax") \
        == [name]
    assert (tmp_path / "port" / name).read_bytes() == \
        (tmp_path / "jax" / name).read_bytes()


# (w, h) of the compaction's host copies: the tests' sizes, a wide
# rectangle and 3840x2160
COMPACT_SIZES = [(64, 64), (128, 128), (512, 256), (3840, 2160)]


def _random_blob(rng, w, h, caps, B=2):
    """A `_tile3d_all_compact` blob of B images with random content:
    accept bits, counts up to each download cap, alive counts and rows
    (idx | mask << 6, accept, type, bbox)."""
    from yaik_tpu_torch.encoder.emit import _scan_perm
    from yaik_tpu_torch.format import swizzle
    parts = []
    for (sx, sy), (_, dcap) in zip(swizzle.TILE3D_PASS_ORDER, caps):
        P = (1 << sx) * (1 << sy)
        Ts = _scan_perm(sx, sy, w, h)[1].shape[0]
        cnt = rng.integers(0, dcap + 1, B).astype("<u4")
        alive = rng.integers(0, Ts + 1, B).astype("<u4")
        rows = rng.integers(0, 256, (B, dcap, P + 9), np.uint8)
        rows[:, :, :P] &= 0x7F
        parts += [rng.integers(0, 256, (B, -(-Ts // 8)), np.uint8),
                  cnt.view(np.uint8).reshape(B, 4),
                  alive.view(np.uint8).reshape(B, 4), rows.reshape(B, -1)]
    return np.concatenate(parts, axis=1)


@pytest.mark.parametrize("w,h", COMPACT_SIZES)
def test_compaction_host_copies_equal_the_jax_package(w, h, monkeypatch):
    """_scan_perm, pass_caps (its keyword fractions against the JAX
    package's environment variables), caps_fit, unpack_compact,
    emit_tile3d_streams_compact, _grad_packed_len and _band_rows (against
    the JAX package's DEVICE_SCORE_MAX_PIX) equal their originals."""
    from yaik_tpu.encoder import batch as jbatch
    from yaik_tpu.encoder import device_pipeline as devp
    from yaik_tpu_torch.encoder import batch, emit, pipeline
    from yaik_tpu_torch.format import swizzle
    for (sx, sy) in swizzle.TILE3D_PASS_ORDER:
        for a, b in zip(emit._scan_perm(sx, sy, w, h),
                        devp._scan_perm(sx, sy, w, h)):
            _assert_same(a, b, f"_scan_perm {sx} {sy}")
    caps = pipeline.pass_caps(w, h)
    assert caps == devp.pass_caps(w, h)
    assert pipeline.pass_caps(w, h, scale=4) == devp.pass_caps(w, h, 4)
    monkeypatch.setenv("YAIK_ENC_CAP_FRAC", "3")
    monkeypatch.setenv("YAIK_ENC_DCAP_FRAC", "40")
    assert pipeline.pass_caps(w, h, 3, 40) == devp.pass_caps(w, h)
    monkeypatch.delenv("YAIK_ENC_CAP_FRAC")
    monkeypatch.delenv("YAIK_ENC_DCAP_FRAC")
    assert batch._grad_packed_len(w, h) == jbatch._grad_packed_len(w, h)
    for max_pix in (1, w * 48 + 5, 2 << 20, batch.DEVICE_SCORE_MAX_PIX):
        monkeypatch.setattr(jbatch, "DEVICE_SCORE_MAX_PIX", max_pix)
        assert batch._band_rows(w, h, max_pix) == jbatch._band_rows(w, h)

    rng = np.random.default_rng(w + h)
    flat = _random_blob(rng, w, h, caps)
    mine = pipeline.unpack_compact(flat, w, h, caps)
    theirs = devp.unpack_compact(flat, w, h, caps)
    _assert_same(mine, theirs, "unpack_compact")
    # caps_fit: nothing overflowed (the caps themselves come back), then
    # the random counts, which overflow the scoring caps
    fitting = [dict(r, alive=np.minimum(r["alive"], scap))
               for r, (scap, _) in zip(mine, caps)]
    assert pipeline.caps_fit(fitting, caps, w, h) is caps
    assert devp.caps_fit(fitting, caps, w, h) is caps
    assert pipeline.caps_fit(mine, caps, w, h) == devp.caps_fit(theirs, caps,
                                                                w, h)

    def streams():
        return {"color": bytearray(), "type": [], 3: bytearray(),
                4: bytearray(), 5: bytearray(), 6: bytearray(),
                "maps": {k: np.zeros(swizzle.bitmap_size_bytes(*k, w, h) * 8,
                                     np.uint8)
                         for k in swizzle.TILE3D_PASS_ORDER}}
    for i in range(2):
        per_img = [{"shift": r["shift"], "bits_scan": r["bits_scan"][i],
                    "count": r["count"][i], "rows": r["rows"][i]}
                   for r in mine]
        got, want = streams(), streams()
        emit.emit_tile3d_streams_compact(per_img, w, h, got)
        devp.emit_tile3d_streams_compact(per_img, w, h, want)
        assert len(got["type"]) == sum(int(r["count"][i]) for r in mine)
        _assert_same(got, want, f"emit_tile3d_streams_compact[{i}]")


# -- the encoder's host passes equal the originals ----------------------------

def _alpha_planes():
    """(alpha plane, case label) of every RGBA image the tests encode: the
    five alpha cases, sprite256, and sprite256 with a transparent border
    (a MIPM chunk with a bbox inside the image)."""
    out = [(rgba_case(n)[:, :, 3], n) for n in sorted(ALPHA_CASES)]
    sprite = _png("sprite256")[:, :, 3].copy()
    out.append((sprite, "sprite256"))
    sprite = sprite.copy()
    sprite[:64], sprite[-64:], sprite[:, :64], sprite[:, -64:] = 0, 0, 0, 0
    out.append((sprite, "sprite256_border"))
    return out


def test_alpha_copy_equals_the_jax_package():
    """mip_prefilter and process_alpha (8-bit, 6-bit full and mipmap-sparse,
    inverse or not, 1-bit), with _pack6 and the level sweep under them."""
    from yaik_tpu.encoder import alpha as jalpha
    from yaik_tpu_torch.encoder import alpha
    for a, label in _alpha_planes():
        got, want = alpha.mip_prefilter(a), jalpha.mip_prefilter(a)
        _assert_same(list(got), list(want), f"mip_prefilter {label}")
        for mask, bound in ((None, (0, 0, a.shape[1], a.shape[0])),
                            (got[0], got[2])):
            for f8 in (True, False):
                for inv in (True, False):
                    assert alpha.process_alpha(a, mask, bound, f8, inv) == \
                        jalpha.process_alpha(a, mask, bound, f8, inv), label
    vals = np.random.default_rng(0).integers(0, 64, 1001).astype(np.uint8)
    for n in (0, 1, 2, 3, 4, 1001):
        assert alpha._pack6(vals[:n]) == jalpha._pack6(vals[:n])


def test_single_color_and_smooth_map_copies_equal_the_jax_package():
    """single_color_out and smooth_map (with what they call of ops/plane.py)
    on img64 and corr2d128, with no mask and with a mipmap mask."""
    from yaik_tpu.encoder import single_color as jsc
    from yaik_tpu.encoder import smooth_map as jsm
    from yaik_tpu_torch.encoder import single_color, smooth_map
    for name in ("img64", "corr2d128"):
        planes = _png(name)[:, :, :3].transpose(2, 0, 1).astype(np.int32)
        h, w = planes.shape[1:]
        mask = np.ones((h, w), bool)
        mask[:16, :] = False
        for m, bound in ((None, (0, 0, w, h)), (mask, (0, 16, w, h))):
            _assert_same(single_color.single_color_out(planes, m, bound),
                         jsc.single_color_out(planes, m, bound), name)
            _assert_same(list(smooth_map.smooth_map(planes, m)),
                         list(jsm.smooth_map(planes, m)), name)


def test_plane_functions_equal_the_jax_package():
    from yaik_tpu.ops import plane as jops
    from yaik_tpu_torch.ops import plane as ops
    rng = np.random.default_rng(1)
    p = rng.integers(-128, 256, (24, 40)).astype(np.int32)
    for order in ("left_right", "top_down"):
        for block in (1, 2):
            _assert_same(ops.apply_diff(p, block, order),
                         jops.apply_diff(p, block, order), order)
    rgb = rng.integers(0, 256, (3, 24, 40))
    _assert_same(list(ops.rgb_to_ycocg(*rgb)), list(jops.rgb_to_ycocg(*rgb)),
                 "rgb_to_ycocg")
    ycc = ops.rgb_to_ycocg(*rgb)
    _assert_same(list(ops.ycocg_to_rgb(*ycc)), list(jops.ycocg_to_rgb(*ycc)),
                 "ycocg_to_rgb")
    for hx, hy in ((1, 0), (0, 1), (1, 1), (0, 0)):
        for mode in ("average", "nearest_tl", "nearest_br", "max", "min"):
            _assert_same(ops.sample_down(p, hx, hy, mode),
                         jops.sample_down(p, hx, hy, mode), mode)
    blobs = np.where(rng.random((40, 48)) < 0.55, 255, 0).astype(np.int32)
    blobs[5:20, 8:30] = 255
    got, want = blobs.copy(), blobs.copy()
    ops.erosion(got)
    jops.erosion(want)
    _assert_same(got, want, "erosion")
    _assert_same(ops.reduce_quarter_logic_max(blobs),
                 jops.reduce_quarter_logic_max(blobs), "reduce_quarter")
    for q in (blobs, np.zeros_like(blobs)):
        assert ops.bbox_nonzero(q) == jops.bbox_nonzero(q)


def test_gradient_host_scorer_equals_the_jax_package():
    """score_pass under every plane mask with claims, and run_pass's
    emission (plane-subset passes after the seven all-plane passes) on
    gradpair192, claims and mapped corners evolving."""
    from yaik_tpu.encoder import gradient as jgrad
    from yaik_tpu_torch.encoder import gradient
    from yaik_tpu_torch.format import swizzle
    planes = _png("gradpair192")[:, :, :3].transpose(2, 0, 1).astype(np.int32)
    h, w = planes.shape[1:]
    state = [(np.zeros((3, h, w), bool), np.zeros((3, h + 1, w + 1), bool))
             for _ in range(2)]
    passes = [(sx, sy, 7) for (sx, sy) in swizzle.GRADIENT_PASS_ORDER] + \
        [(2, 2, m) for m in (5, 3, 6, 1, 2, 4)]
    for sx, sy, m in passes:
        _assert_same(gradient.score_pass(planes, state[0][0], sx, sy, 3, m),
                     jgrad.score_pass(planes, state[1][0], sx, sy, 3, m),
                     f"score_pass {sx} {sy} {m}")
        got = gradient.run_pass(planes, *state[0], sx, sy, 3, 250, m)
        want = jgrad.run_pass(planes, *state[1], sx, sy, 3, 250, m)
        assert got == want, (sx, sy, m)
        _assert_same(state[0], state[1], f"claims after {sx} {sy} {m}")
    assert state[0][0].any()
    v = np.arange(-2, 300)
    _assert_same(gradient.round6p(v), jgrad.round6p(v), "round6p")


def test_bank2d_copy_equals_the_jax_package():
    """load_bank2d's contexts array by array (the 2D bank is the codec's
    counterpart of weights), and the LutFile2D it writes, which is the
    committed tests/fixtures/LutFile2D.lut."""
    from yaik_tpu.encoder import bank2d as jbank2d
    from yaik_tpu_torch.encoder import bank2d
    got = bank2d.load_bank2d(str(FIX / "Bank2D"))
    want = jbank2d.load_bank2d(str(FIX / "Bank2D"))
    assert got.count == want.count == 12
    for i, (a, b) in enumerate(zip(got.ctxs, want.ctxs)):
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"ctxs[{i}].{f.name}")
    _assert_same(got.points, want.points, "points")
    lut = bank2d.write_lut2d_file(got)
    assert lut == jbank2d.write_lut2d_file(want)
    assert lut == (FIX / "LutFile2D.lut").read_bytes()


def test_corr2d_copy_equals_the_jax_package():
    """run_pass of each plane mode and size on corr2d128's top-left 64x64,
    claims from the gradient passes and evolving across the passes."""
    from yaik_tpu.encoder import bank2d as jbank2d
    from yaik_tpu.encoder import corr2d as jcorr2d
    from yaik_tpu.encoder import gradient as jgrad
    from yaik_tpu_torch.encoder import bank2d, corr2d
    from yaik_tpu_torch.format import swizzle
    planes = _png("corr2d128")[:64, :64, :3].transpose(2, 0, 1).astype(
        np.int32)
    claims = np.zeros((3, 64, 64), bool)
    mapped = np.zeros((3, 65, 65), bool)
    for (sx, sy) in swizzle.GRADIENT_PASS_ORDER:
        jgrad.run_pass(planes, claims, mapped, sx, sy, 3, 250)
    banks = (bank2d.load_bank2d(str(FIX / "Bank2D")),
             jbank2d.load_bank2d(str(FIX / "Bank2D")))
    state = []
    for _ in range(2):
        streams = {"color": bytearray(), "type": [], 3: bytearray(),
                   4: bytearray(), 5: bytearray(), 6: bytearray(),
                   "maps": {k: np.zeros(swizzle.bitmap_size_bytes(
                       *k, 64, 64) * 8, np.uint8) for k in ((3, 3), (2, 2))}}
        state.append((claims.copy(), streams))
    for mode in (0, 1, 2):
        for (sx, sy) in ((3, 3), (2, 2)):
            corr2d.run_pass(planes, state[0][0], banks[0], mode, sx, sy,
                            state[0][1])
            jcorr2d.run_pass(planes, state[1][0], banks[1], mode, sx, sy,
                             state[1][1])
            _assert_same(list(state[0]), list(state[1]), f"{mode} {sx}")
    assert state[0][1]["type"]
    assert corr2d.COMPONENT == jcorr2d.COMPONENT


def test_plnt_copy_equals_the_jax_package():
    """encode_plnt on img64 (no mask) and under a mipmap mask and bound,
    and the curve tables the PLNT plane decode reads."""
    from yaik_tpu.encoder import plnt as jplnt
    from yaik_tpu_torch.encoder import plnt
    planes = _png("img64")[:, :, :3].transpose(2, 0, 1).astype(np.int32)
    mask = np.zeros((64, 64), bool)
    mask[16:48, 8:56] = True
    for m, bound in ((None, (0, 0, 64, 64)), (mask, (8, 16, 56, 48))):
        assert plnt.encode_plnt(planes, m, bound) == \
            jplnt.encode_plnt(planes, m, bound)
    for mn, mx in ((0, 255), (10, 40), (229, 239), (0, 0), (250, 251)):
        assert plnt.build_table(mn, mx) == jplnt.build_table(mn, mx)
    for v in range(0, 64, 7):
        bn = plnt.min_range_decode(v)
        assert bn == jplnt.min_range_decode(v)
        for r in range(0, 128, 9):
            assert plnt.diff_range_decode(r, bn) == \
                jplnt.diff_range_decode(r, bn)
            d = plnt.diff_range_decode(r, bn)
            assert plnt.curves_from(bn, d) == jplnt.curves_from(bn, d)


# -- chip_smoke's reference values are current --------------------------------

@pytest.fixture(scope="module")
def digests():
    return json.loads(DIGESTS.read_text())


def test_digest_entries_are_chip_smokes():
    d = json.loads(DIGESTS.read_text())
    assert sorted(d["decode"]) == sorted(DECODED)
    assert sorted(d["encode"]) == sorted(ENCODED)


@pytest.mark.parametrize("kind,name", [("decode", n) for n in DECODED]
                         + [("encode", n) for n in ENCODED])
def test_digest_is_current(kind, name, digests, banks):
    """Each committed digest equals what the JAX package computes now."""
    assert digest(reference_pixels(kind, name, banks[1])) == \
        digests[kind][name]


@pytest.mark.parametrize("name", sorted(RGBA))
def test_rgba_fixture_is_current(name, digests, banks):
    """A committed RGBA stream decodes to the pixels of the JAX package's
    host encode of its image now, and the port decodes it to its digest."""
    import yaik_tpu_torch
    from yaik_tpu.decoder import reference
    img, config = RGBA[name]
    fresh = _host_encode(img(), **config)
    jax_bank = banks[1]
    want = reference.decode(fresh, jax_bank.expanded)
    assert want.shape[2] == 4
    assert np.array_equal(reference.decode(stream_of(name), jax_bank.expanded),
                          want)
    got = yaik_tpu_torch.decode_image(stream_of(name), banks[0], device="cpu")
    assert digest(got) == digests["decode"][name]


if __name__ == "__main__":
    write_reference_values()
