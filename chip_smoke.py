#!/usr/bin/env python3
"""Smoke run of the yaik_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Imports nothing of jax or of the JAX package `yaik_tpu`: the port's own
host modules plan and pack, and every reference value it checks against is
committed (the `.dec.npz` goldens, and `tests/fixtures/port_digests.json`,
digests of the JAX package's host decoder's pixels, which
tests/test_torch_selfcontained.py keeps current on the CPU).

Builds the port's CUDA kernels from `yaik_tpu_torch/ops/csrc/` and the
port's host library, holds each kernel against its plain PyTorch version on
the card (exact equality: the arithmetic is integer, or float32 in one fixed
op order), then drives the main paths through the user's entry points,
counting each kernel's launches against what the operands call for:
- decode of the six standard fixtures through
  `yaik_tpu_torch.decode_image(..., device="cuda")` in the split form, in
  the fused form (`t3_d1=True, grad_final=True`: two launches, the
  `t3_merged_d1` and `grad_plane_final` kernels) and with each flag alone,
  pixels held against the goldens (`bench_4k` against its digest) and the
  split form; the flags shown ignored where a stream does not qualify
  (UCOL, 2DTL);
- decode of the other chunk families: 2DTL (`bench_2d512`, `corr2d128.2d`,
  merged and per-pass), UCOL/SMAP (`bench_ucol512`, `img64.ucol`,
  `img512.ucol`), plane gradients (`gradpair192.gp`), RGBA (`bench_rgba512`,
  five 64x64 alpha cases and `sprite256` twice, committed as
  `tests/fixtures/*.rgba.yaik`), the crafted 3-layer T3 stream and
  `bench_4k` in the per-pass T3 form, each held against its golden or
  digest;
- encode of img64, img128, quilt128, img512 and the 3840x2160 image (the
  decode of `bench_4k`) through `yaik_tpu_torch.encode_image(...,
  device="cuda")`: bytes held against the plain-path twin in this process
  (`api.score_image(..., plain=True)` + `api.emit_image`), decoded pixels
  against their digests (the 4K stream against the port's CPU decode).
The encode kernels (`score48`, `score48_mode` and `values48`) are held
against their plain versions on all six 3D passes of img512 and of the 4K
image, on random operands (P 16-128, E up to 128, wild dead pixels in mixed
tiles), on patterns with ties and on a bank no tile takes; the encode run
shows `score48_mode` and `values48` launched once per 3D pass and the sums
form `score48` not at all.
Then the decodes, the encode and each kernel against its plain version are
timed with CUDA events (`score48_mode` and `values48` on all six 4K
passes, the sums form on the 4x4 pass, beside the bounds of each pass's
work), and torch.profiler sums one warm 4K scoring call by kernel name.
A kernel's launches are its wrapper's calls: a `values48` call runs three
CUDA kernels (table packing, decision, idx).

The last lines are the card as nvidia-smi names it, one JSON line with the
kernels (time, plain time, the card's least time for the same work and what
bounds it), and `{"ok": true, "device": {...}}`. Any failure raises, and the
script exits non-zero; so does a run without a GPU, where it prints no
result.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
FIX = ROOT / "tests" / "fixtures"
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT))
SMALL = ["img64", "img128", "quilt128", "img512", "img512b"]
ENCODE = ["img64", "img128", "quilt128", "img512"]
FAMILIES = ["bench_2d512", "corr2d128.2d", "bench_ucol512", "img64.ucol",
            "img512.ucol", "gradpair192.gp", "bench_rgba512"]
RGBA = ["alpha64_1bit", "alpha64_6bit", "alpha64_8bit", "alpha64_const255",
        "alpha64_sparse", "sprite256", "sprite256_6bit"]
DECODE_KERNELS = ("grad_plane", "grad_plane_final", "t3_merged",
                  "t3_merged_d1", "t2_merged", "lut_pass")
ENCODE_KERNELS = ("score48", "score48_mode", "values48")
KERNELS = {
    "grad_plane": ("yaik_tpu_torch/ops/csrc/grad_plane.cu",
                   "yaik_tpu/ops/pallas_kernels.py:311"),
    # grad_plane with the final-composition epilogue
    "grad_plane_final": ("yaik_tpu_torch/ops/csrc/grad_plane.cu",
                         "yaik_tpu/ops/pallas_kernels.py:350"),
    "t3_merged": ("yaik_tpu_torch/ops/csrc/t3_merged.cu",
                  "yaik_tpu/ops/pallas_kernels.py:638"),
    # both merged T3 layers with the 1D-residual epilogue, image order
    "t3_merged_d1": ("yaik_tpu_torch/ops/csrc/t3_merged.cu",
                     "yaik_tpu/ops/pallas_kernels.py:604"),
    # lut3d_vals_dict2p with chan=True (the merged-2DTL form)
    "t2_merged": ("yaik_tpu_torch/ops/csrc/t3_merged.cu",
                  "yaik_tpu/ops/pallas_kernels.py:638"),
    # lut3d_vals in its per-pass roles (and lut3d_vals_dict, :163)
    "lut_pass": ("yaik_tpu_torch/ops/csrc/lut_pass.cu",
                 "yaik_tpu/ops/pallas_kernels.py:100"),
    "score48": ("yaik_tpu_torch/ops/csrc/score48.cu",
                "yaik_tpu/ops/pallas_kernels.py:409"),
    # score48 with the pattern-argmin epilogue: the Pallas score48 together
    # with the argmin after it (yaik_tpu/encoder/jax_scoring.py:354)
    "score48_mode": ("yaik_tpu_torch/ops/csrc/score48.cu",
                     "yaik_tpu/ops/pallas_kernels.py:409"),
    "values48": ("yaik_tpu_torch/ops/csrc/values48.cu",
                 "yaik_tpu/ops/pallas_kernels.py:906"),
}
# the card's peaks (NVIDIA H100 SXM data sheet, dense): HBM bytes/s, float32
# outside the tensor cores, and int32 (64 lanes per SM per clock, half the
# float32 rate)
HBM_BPS = 3.35e12
PEAK_OPS = {"f32": 67e12, "i32": 33.5e12}


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def cuda_ms(fn, iters: int, queued: bool = True) -> float:
    """Mean device milliseconds per call over `iters` back-to-back calls,
    by CUDA events, after warm-up. With `queued`, the stream first sleeps
    on the card for twice the host time the calls take to enqueue, so the
    events time the device work alone (the calls must then launch fewer
    than ~1000 kernels in all, or the host blocks on the full launch
    queue); without it they also time the host's dispatch where the card
    waits for it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        t = time.perf_counter()
        for _ in range(2):
            fn()
        host_s = (time.perf_counter() - t) / 2
        torch.cuda.synchronize()
        # ~2e9 cycles/s at the H100's 1980 MHz boost clock
        torch.cuda._sleep(int(2 * iters * host_s * 2e9) + 1000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    return int((got.cpu().to(torch.int64)
                - want.cpu().to(torch.int64)).abs().max())


def v48_operands(rng, T: int, P: int, E: int) -> list:
    """Random values-stage operands (as tests/test_values48.py makes them):
    dead pixels with wild normalizations, one all-dead tile."""
    alive = rng.random((T, P)) < 0.7
    alive[T // 2] = False
    a_c = rng.integers(0, 64, (T, P, 3))
    b_c = np.clip(63 - a_c - rng.integers(0, 2, (T, P, 3)), 0, 63)
    wild = (rng.random((T, P, 3)) < 0.05) & ~alive[:, :, None]
    a_c = np.where(wild, rng.integers(-(1 << 24), 1 << 24, (T, P, 3)), a_c)
    b_c = np.where(wild, rng.integers(-(1 << 24), 1 << 24, (T, P, 3)), b_c)
    ops = [rng.integers(0, 256, (T, P, 3)), alive, a_c, b_c,
           rng.integers(0, 48, (T, E)), rng.integers(0, 200, (T, 3)),
           rng.integers(1, 128, (T, 3)), rng.integers(0, 64, (E, 64, 3)),
           rng.integers(0, 128, (4, E, 64, 3))]
    return [torch.from_numpy(a if a.dtype == bool else a.astype(np.int32))
            for a in ops]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(reads: list, writes: list, ops: float, kind: str,
          moved: float | None = None) -> tuple:
    """The card's least time (ms) for a call that reads each tensor of
    `reads` once, writes each of `writes` once (or moves `moved` bytes,
    where the function needs only part of its tensors) and does `ops`
    operations of `kind`; and which of the two bounds it."""
    if moved is None:
        moved = nbytes(*reads, *writes)
    t_bytes, t_ops = moved / HBM_BPS, ops / PEAK_OPS[kind]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def planes_of(img: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        img.transpose(2, 0, 1), np.int32)).to(dev)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]

    # -- phase 1: the card, the host library and the kernel build ----------
    import yaik_tpu_torch
    from PIL import Image
    from torch_streams import (craft_t3_stream, d1_operands, digest,
                               synth_t2_pass)
    from yaik_tpu_torch import native
    from yaik_tpu_torch.decoder import engine, pack, planner
    from yaik_tpu_torch.encoder import api, pipeline, scoring, tables
    from yaik_tpu_torch.encoder import bank as bankmod
    from yaik_tpu_torch.entropy import zstd_backend
    from yaik_tpu_torch.format import swizzle
    from yaik_tpu_torch.ops import build, kernels
    nvcc = run([build._nvcc(), "--version"]).splitlines()[-1]
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {nvcc}, python {sys.version.split()[0]}")
    t = time.perf_counter()
    host_ok = native.available()          # builds the host library if absent
    print(f"host: yaik_tpu_torch host library loaded={host_ok} "
          f"({native.library_path().name}, {time.perf_counter() - t:.2f} s "
          f"with its build); zstd {zstd_backend.VERSION} (reference build "
          f"{zstd_backend.IS_REFERENCE_ZSTD})")
    t = time.perf_counter()
    path, log = build.build()
    build.library()
    build_s = time.perf_counter() - t
    print(f"kernels: {'compiled' if log else 'found'} {path.name} and "
          f"loaded in {build_s:.2f} s")
    for line in log.splitlines():      # ptxas: registers, spills per kernel
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    digests = json.loads((FIX / "port_digests.json").read_text())

    def hold(label: str, got: np.ndarray, name: str) -> None:
        """Pixels of stream `name` against its golden, else its digest of
        the JAX package's reference.decode."""
        npz = FIX / f"{name}.dec.npz"
        if npz.exists():
            want = np.load(npz)["rgb"]
            ok, what = (got.shape == want.shape
                        and np.array_equal(got, want)), "golden"
        else:
            ok = digest(got) == digests["decode"][name]
            what = "digest of reference.decode"
        print(f"decode {label} {'x'.join(map(str, got.shape))}: "
              f"{'equal to' if ok else 'DIFFERS from'} its {what}")
        if not ok:
            raise AssertionError(f"decode of {label} is wrong")

    bank = yaik_tpu_torch.assign_lut((FIX / "LutFile.lut").read_bytes(),
                                     (FIX / "LutFile2D.lut").read_bytes())
    dtabs = engine.Tables.build(bank.expanded, bank.expanded2d, dev)
    lut, tab = dtabs.lut, dtabs.tab
    streams = {n: (FIX / f"{n}.yaik").read_bytes() for n in SMALL
               + ["bench_4k"]}
    plans = {n: planner.build_plan(s, bank.expanded)
             for n, s in streams.items()}
    std_args = {n: pack.plan_to_args(p, lut) for n, p in plans.items()}
    ops = {n: engine.upload(std_args[n], dev) for n in ("img512", "bench_4k")}
    bank3d = bankmod.load_bank(str(FIX / "Bank3D"))
    tabs = tables.device_tables(bank3d, dev)
    images = {n: np.asarray(Image.open(FIX / f"{n}.png")) for n in ENCODE}
    t = time.perf_counter()
    images["bench_4k"] = np.ascontiguousarray(yaik_tpu_torch.decode_image(
        streams["bench_4k"], bank, device="cpu"))
    print(f"host: the port's CPU decode of bench_4k (the 4K encode input) "
          f"{time.perf_counter() - t:.2f} s")
    hold("bench_4k on the CPU", images["bench_4k"], "bench_4k")
    # the other chunk families: committed streams (RGBA among them) and the
    # crafted 3-layer T3 stream
    fam = {n: (FIX / f"{n}.yaik").read_bytes() for n in FAMILIES}
    fam["crafted_3layer"] = craft_t3_stream(64, 64, True)
    fam.update({n: (FIX / f"{n}.rgba.yaik").read_bytes() for n in RGBA})
    fplans = {n: planner.build_plan(s, bank.expanded, bank.expanded2d)
              for n, s in fam.items()}

    # -- phase 2: each kernel against its plain version, exactly -----------
    err = dict.fromkeys(KERNELS, 0)

    def check(name: str, label: str, *a) -> torch.Tensor:
        got = getattr(kernels, name)(*a)
        torch.cuda.synchronize()
        e = max_abs_err(got, getattr(kernels, f"{name}_plain")(*a))
        err[name] = max(err[name], e)
        print(f"check {name} {label} {tuple(got.shape)}: max_abs_err {e}")
        if e:
            raise AssertionError(f"{name} disagrees at {label}")
        return got

    def t3_args(d):
        return (tab, d.idx16, d.cols, d.accept, d.rows)

    def d1_args(d):
        return (*t3_args(d), d.d1_prm, d.d1_codes4, d.d1_wm2, d.height,
                d.width)

    rng = np.random.default_rng(0)
    for n, d in ops.items():
        check("grad_plane", n, d.corners, d.code4)
        check("t3_merged", n, *t3_args(d))
        vc = check("t3_merged_d1", n, *d1_args(d))
        check("grad_plane_final", n, d.corners, d.code4, vc)
    for H, W in ((64, 1024), (40, 1288)):
        corners, code4 = (torch.from_numpy(a).to(dev) for a in (
            rng.integers(0, 1 << 24, (7, H // 4 + 1, W // 4 + 1)).astype(
                np.int32),
            rng.integers(0, 8, (H // 4, W // 4)).astype(np.uint8)))
        check("grad_plane", f"random {H}x{W}", corners, code4)
        vc = torch.from_numpy(rng.integers(0, 1 << 27, (H, W)).astype(
            np.int32)).to(dev)
        check("grad_plane_final", f"random {H}x{W}, random flags", corners,
              code4, vc)

    def t3_random(G: int) -> list:
        """Random merged-T3 operands with max < min tiles; layer 0 accepts
        nothing in the first third of the blocks."""
        cols = rng.integers(0, 256, (2, G, 6)).astype(np.uint8)
        if not (cols[..., 3:] < cols[..., :3]).any():
            raise AssertionError("random T3 operands hold no max < min tile")
        accept = rng.integers(0, 2, (2, G)).astype(np.uint8)
        accept[0, : G // 3] = 0
        return [torch.from_numpy(a).to(dev) for a in (
            rng.integers(0, 128, (2, G, 16)).astype(np.uint8), cols, accept,
            rng.integers(0, lut.tab.shape[0], (2, G)).astype(np.int32))]

    check("t3_merged", "random, mx < mn", tab, *t3_random(200_000))
    for H, W in ((40, 1288), (1000, 1004)):
        G = (H // 4) * (W // 4)
        d1 = [torch.from_numpy(x).to(dev) for x in d1_operands(rng, G)]
        got = check("t3_merged_d1", f"random {H}x{W}", tab, *t3_random(G),
                    *d1, H, W)
        flags = (got >> 24) & 7
        for f in (1, 2, 4):      # one channel written, by the 1D value alone
            if not bool((flags == f).any()):
                raise AssertionError(f"random {H}x{W}: no pixel with flags {f}")

    # -- phase 2a: the two per-family LUT kernels against their plain ------
    def check_t2(label, lay):
        check("t2_merged", label, dtabs.tab2, lay.idx16, lay.cols,
              lay.accept, lay.rows)

    def pass_args(tb, p, H, W):
        (sx, sy), (nty, ntx) = p.shift, p.grid
        return (tb, p.packed, p.cols, p.chm, p.rows, nty, ntx, 1 << sy,
                1 << sx, H, W)

    def check_pass(label, tb, p, H, W):
        check("lut_pass", f"{label} {1 << p.shift[0]}x{1 << p.shift[1]} "
              "tiles", *pass_args(tb, p, H, W))

    def synth_t2_plan(h, w, seed):
        """Two overlapping 2D passes of modes 0 (8x8) and 1 (4x4), 70% of
        tiles each: both merged layers hold tiles (tests/test_t2_merged.py)."""
        r = np.random.default_rng(seed)
        return SimpleNamespace(height=h, width=w, tile2d=[
            synth_t2_pass(r, 0, (3, 3), h // 8, w // 8,
                          r.random((h // 8, w // 8)) < 0.7),
            synth_t2_pass(r, 1, (2, 2), h // 4, w // 4,
                          r.random((h // 4, w // 4)) < 0.7)])

    synth = {}
    for label, (h, w) in (("64x64", (64, 64)), ("512x512", (512, 512)),
                          ("3840x2160", (2160, 3840))):
        lay = pack.t2_merge_layers(synth_t2_plan(h, w, h), dtabs.lut2)
        if lay is None or not lay.accept[1].any():
            raise AssertionError("synthetic 2D layers do not overlap")
        synth[label] = pack.map_arrays(
            lay, lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev))
        check_t2(f"synthetic overlapping layers {label}", synth[label])
    fam_args = {}
    for n in ("bench_2d512", "corr2d128.2d"):
        for form in ("merged", "passes"):
            fam_args[n, form] = engine.upload(pack.plan_to_args(
                fplans[n], lut, dtabs.lut2, t2_form=form), dev)
        check_t2(n, fam_args[n, "merged"].t2_layers)
        for p in fam_args[n, "passes"].t2_passes:
            check_pass(f"{n} 2DTL pass", dtabs.tab2, p, fplans[n].height,
                       fplans[n].width)
    hw4k = plans["bench_4k"].height, plans["bench_4k"].width
    pass4k = engine.upload(pack.plan_to_args(plans["bench_4k"], lut,
                                             t3_form="passes"), dev)
    for p in pass4k.t3_passes:
        check_pass("bench_4k T3 pass", tab, p, *hw4k)
    crafted = engine.upload(pack.plan_to_args(fplans["crafted_3layer"], lut),
                            dev)
    for p in crafted.t3_passes:
        check_pass("crafted 3-layer T3 pass", tab, p, 64, 64)
    # random: idx bytes with write bits, half the tiles not accepted, and a
    # 2168x3848 image that the 16-pixel tiles cover only to 2160x3840
    for sx, sy in ((4, 3), (3, 4), (2, 2)):
        H, W = 2168, 3848
        nty, ntx = H >> sy, W >> sx
        g = nty * ntx
        p = pack.LutPass((sx, sy), (nty, ntx), *(
            torch.from_numpy(a).to(dev) for a in (
                rng.integers(0, 128, (g, 1 << (sx + sy))).astype(np.uint8),
                rng.integers(0, 256, (g, 6)).astype(np.uint8),
                (rng.integers(0, 2, g) * 7).astype(np.uint8),
                rng.integers(0, lut.tab.shape[0], g).astype(np.int32))))
        check_pass("random, half the tiles not accepted", tab, p, H, W)

    # -- phase 2b: the encode kernels against their plain versions --------
    def check_kernel(name, label, got, want):
        torch.cuda.synchronize()
        e = max(max_abs_err(g, w) for g, w in zip(got, want))
        err[name] = max(err[name], e)
        print(f"check {name} {label} {tuple(got[-1].shape)}: max_abs_err {e}")
        if e:
            raise AssertionError(f"{name} disagrees at {label}")

    def check_score_values(label, o):
        alive = ~o.mask
        check_kernel("score48", label, [kernels.score48(o.c, alive, tabs.qpts)],
                     [kernels.score48_plain(o.c, alive, tabs.qpts)])
        mode = kernels.score48_mode(o.c, alive, tabs.qpts)
        check_kernel("score48_mode", label, [mode],
                     [kernels.score48_mode_plain(o.c, alive, tabs.qpts)])
        args = (o.tiles, alive, o.a_c, o.b_c, mode, o.mn, o.mx - o.mn,
                tabs.pts, tabs.factors)
        check_kernel("values48", label, kernels.values48(*args),
                     kernels.values48_plain(*args))
        return o.c, args

    # real operands: every pass of img512 and of the 4K image; claims evolve
    # through the gradient stage and the kernel path
    enc_args = {}
    for n in ("img512", "bench_4k"):
        planes = planes_of(images[n], dev)
        claims = torch.zeros(planes.shape, dtype=torch.bool, device=dev)
        scoring.gradient_all(planes, claims, 3)
        for (sx, sy) in swizzle.TILE3D_PASS_ORDER:
            enc_args[n, sx, sy] = check_score_values(
                f"{n} pass {1 << sx}x{1 << sy}",
                scoring.tile3d_operands(planes, claims, sx, sy))
            scoring.tile3d_pass(planes, claims, tabs, sx, sy)
    # random operands: wild dead pixels in mixed tiles, one all-dead tile,
    # banks up to the Pallas kernel's 128 LUTs
    for P in (16, 32, 64, 128):
        for E in (12, 22, 128):
            T = 4001 if E < 128 else 1001
            a = [x.to(dev) for x in v48_operands(rng, T, P, E)]
            check_kernel("values48", f"random P={P} E={E}, wild dead pixels",
                         kernels.values48(*a), kernels.values48_plain(*a))
            c = torch.from_numpy(rng.integers(0, 64, (T, P, 3)).astype(
                np.int32)).to(dev)
            q = torch.from_numpy(rng.integers(0, 64, (E, 48, 8, 3)).astype(
                np.int32)).to(dev)
            for name in ("score48", "score48_mode"):
                check_kernel(name, f"random P={P} E={E}",
                             [getattr(kernels, name)(c, a[1], q)],
                             [getattr(kernels, f"{name}_plain")(c, a[1], q)])
    # ties: each LUT's 48 patterns are 6 runs of 8 identical ones, so equal
    # sums must give the first pattern of a run
    q = torch.from_numpy(np.repeat(rng.integers(0, 64, (12, 6, 8, 3)), 8,
                                   axis=1).astype(np.int32)).to(dev)
    for P in (16, 128):
        c = torch.from_numpy(rng.integers(0, 64, (2001, P, 3)).astype(
            np.int32)).to(dev)
        alive = torch.from_numpy(rng.random((2001, P)) < 0.5).to(dev)
        mode = kernels.score48_mode(c, alive, q)
        check_kernel("score48_mode", f"ties P={P}", [mode],
                     [kernels.score48_mode_plain(c, alive, q)])
        if bool((mode % 8).any()):
            raise AssertionError("score48_mode broke a tie to a later pattern")
    a = v48_operands(rng, 64, 16, 3)
    a[1] = torch.ones((64, 16), dtype=torch.bool)
    a[8] = torch.full((4, 3, 64, 3), 4000, dtype=torch.int32)
    a = [x.to(dev) for x in a]
    got = kernels.values48(*a)
    check_kernel("values48", "random, all-skip factors", got,
                 kernels.values48_plain(*a))
    if got[0].any():
        raise AssertionError("values48 accepted a tile with all-skip factors")

    # -- phase 3: the standard decode, split and fused, through the user's
    # entry point; each run starts its kernels' counts at 0 --------------
    def reset():
        for name in DECODE_KERNELS:
            getattr(kernels, name).launches = 0

    def counts() -> dict:
        return {name: getattr(kernels, name).launches
                for name in DECODE_KERNELS}

    def expected(args, t3_d1=False, grad_final=False) -> dict:
        """Launches of one decode_core call on `args`, kernel by kernel,
        with the fused forms applied where the stream qualifies."""
        compose = (args.idx16 is not None and args.pgrad is None
                   and args.t2_layers is None and args.t2_passes is None)
        d1 = t3_d1 and compose
        final = grad_final and compose and args.overlay is None
        return {"grad_plane": int(not final)
                + sum(g is not None for g in args.pgrad or ()),
                "grad_plane_final": int(final),
                "t3_merged": int(args.idx16 is not None and not d1),
                "t3_merged_d1": int(d1),
                "t2_merged": int(args.t2_layers is not None),
                "lut_pass": sum(p is not None for p in (args.t3_passes or ())
                                + (args.t2_passes or ()))}

    def total(arg_list, **flags) -> dict:
        want = dict.fromkeys(DECODE_KERNELS, 0)
        for a in arg_list:
            for name, k in expected(a, **flags).items():
                want[name] += k
        return want

    def decode_run(label, srcs, arg_of, **flags):
        """Decode every stream of `srcs` through decode_image with `flags`,
        holding the launches to what the operands call for."""
        reset()
        outs = {n: yaik_tpu_torch.decode_image(s, bank, device="cuda",
                                               **flags)
                for n, s in srcs.items()}
        got = counts()
        want = total([arg_of[n] for n in srcs], **flags)
        print(f"launches in the {label} decode run ({len(srcs)} streams): "
              f"{got}")
        if got != want:
            raise AssertionError(f"{label} decode launches {got}, operands "
                                 f"call for {want}")
        for n, out in outs.items():
            hold(f"{n} ({label})", out, n)
        return outs, got

    outs, launches = decode_run("split standard", streams, std_args)
    fused, fused_launches = decode_run("fused standard", streams, std_args,
                                       t3_d1=True, grad_final=True)
    if fused_launches != {**dict.fromkeys(DECODE_KERNELS, 0),
                          "t3_merged_d1": len(streams),
                          "grad_plane_final": len(streams)}:
        raise AssertionError("a fused standard decode is not one "
                             "t3_merged_d1 + one grad_plane_final launch")
    for name in ("t3_merged_d1", "grad_plane_final"):
        launches[name] = fused_launches[name]
    for label, flags in (("t3_d1 only", dict(t3_d1=True)),
                         ("grad_final only", dict(grad_final=True))):
        one, _ = decode_run(label, streams, std_args, **flags)
        fused.update({f"{n} {label}": o for n, o in one.items()})
    for n, out in fused.items():
        if not np.array_equal(out, outs[n.split()[0]]):
            raise AssertionError(f"fused decode of {n} differs from split")
    print(f"decode: the fused forms of {len(fused)} standard decodes equal "
          "the split form's pixels")
    fam_args.update({n: pack.plan_to_args(p, lut, dtabs.lut2)
                     for n, p in fplans.items()})
    ignored = {n: fam[n] for n in ("bench_ucol512", "img512.ucol",
                                   "bench_2d512", "corr2d128.2d")}
    print("decode: UCOL and 2DTL streams with both fused flags: grad_final "
          "does not apply to either, t3_d1 to the UCOL streams only")
    decode_run("flags-ignored", ignored, fam_args,
               t3_d1=True, grad_final=True)

    # -- phase 3a: the other chunk families, through the same entry point --
    reset()
    fouts = {n: yaik_tpu_torch.decode_image(s, bank, device="cuda")
             for n, s in fam.items()}
    forced = {n: engine.decode_plan(fplans[n], dtabs, t2_form="passes")
              for n in ("bench_2d512", "corr2d128.2d")}
    forced["bench_4k"] = engine.decode_plan(plans["bench_4k"], dtabs,
                                            t3_form="passes")
    fam_launches = counts()
    want_launches = total([fam_args[n] for n in fam]
                          + [fam_args[n, "passes"] for n in ("bench_2d512",
                                                             "corr2d128.2d")]
                          + [pass4k])
    print(f"launches in the family decode run: {fam_launches} "
          f"({len(fam)} streams through decode_image, 2DTL twice per pass, "
          f"bench_4k per pass)")
    if fam_launches != want_launches:
        raise AssertionError(f"family decode launches {fam_launches}, "
                             f"operands call for {want_launches}")
    for name in ("grad_plane", "t3_merged", "t2_merged", "lut_pass"):
        if fam_launches[name] == 0:
            raise AssertionError(f"{name} was not launched by the family "
                                 "decodes")
        launches[name] += fam_launches[name]
    for n, out in fouts.items():
        if fplans[n].has_alpha and out.shape[2] != 4:
            raise AssertionError(f"{n} decodes without its alpha channel")
        hold(n, out, n)
    for n, out in forced.items():
        ok = np.array_equal(out, fouts[n] if n in fouts else outs[n])
        print(f"decode {n} in the per-pass {'T3' if n == 'bench_4k' else '2DTL'}"
              f" form: {'equal to' if ok else 'DIFFERS from'} the merged form's")
        if not ok:
            raise AssertionError(f"per-pass decode of {n} is wrong")
        hold(f"{n} per pass", out, n)

    # -- phase 3b: the encode path, through the user's entry point ---------
    for name in ENCODE_KERNELS:
        getattr(kernels, name).launches = 0
    encoded = {n: yaik_tpu_torch.encode_image(img, bank3d, device="cuda")
               for n, img in images.items()}
    launches.update({name: getattr(kernels, name).launches
                     for name in ENCODE_KERNELS})
    print("launches in the encode run (wrapper calls; a values48 call runs "
          "three CUDA kernels): " + ", ".join(
              f"{name} {launches[name]}" for name in ENCODE_KERNELS))
    # one score48_mode and one values48 per 3D pass; the sums form is off
    # the encode path
    want = {"score48": 0, "score48_mode": 6 * len(images),
            "values48": 6 * len(images)}
    if {name: launches[name] for name in ENCODE_KERNELS} != want:
        raise AssertionError(f"encode launches {launches}, {len(images)} "
                             f"encodes call for {want}")
    for n in ENCODE:
        t = time.perf_counter()
        twin = api.emit_image(images[n], *api.score_image(
            images[n], bank3d, "cuda", plain=True))
        px = yaik_tpu_torch.decode_image(encoded[n], bank, device="cuda")
        ok = encoded[n] == twin and digest(px) == digests["encode"][n]
        print(f"encode {n}: {len(encoded[n])} bytes, "
              f"{'equal to' if encoded[n] == twin else 'DIFFERS from'} the "
              f"plain-path twin's ({time.perf_counter() - t:.2f} s), decoded "
              f"{'equal to' if ok else 'DIFFERS from'} the digest of the "
              "host engine's stream decoded")
        if not ok:
            raise AssertionError(f"encode of {n} is wrong")
    img4k, stream4k = images["bench_4k"], encoded["bench_4k"]
    got = api.score_image(img4k, bank3d, "cuda")
    plain = api.score_image(img4k, bank3d, "cuda", plain=True)
    same = all(np.array_equal(a, b) for a, b in zip(got[0], plain[0])) and \
        all(all(np.array_equal(a[k], b[k]) for k in a)
            for a, b in zip(got[1], plain[1]))
    print(f"encode bench_4k {img4k.shape[1]}x{img4k.shape[0]}: all six "
          f"passes' outputs "
          f"{'equal' if same else 'DIFFER'} between the kernel and plain "
          f"paths; {sum(int(r['accept'].sum()) for r in got[1])} 3D tiles")
    if not same:
        raise AssertionError("4K kernel-path scoring differs from plain")
    back = yaik_tpu_torch.decode_image(stream4k, bank, device="cuda")
    ok = np.array_equal(back, yaik_tpu_torch.decode_image(stream4k, bank,
                                                          device="cpu"))
    print(f"encode bench_4k: {len(stream4k)} bytes "
          f"({8 * len(stream4k) / img4k[..., 0].size:.3f} bits/pixel), "
          f"decode_image(cuda) {'equal to' if ok else 'DIFFERS from'} "
          f"decode_image(cpu), PSNR {psnr(back, img4k):.2f} dB vs the input")
    if not ok:
        raise AssertionError("the 4K stream decodes wrong on the card")

    # -- phase 4: timing ---------------------------------------------------
    kms = {}
    for n in streams:
        stream = streams[n]
        t = time.perf_counter()
        args = pack.plan_to_args(planner.build_plan(stream, bank.expanded),
                                 lut)
        host_ms = (time.perf_counter() - t) * 1e3
        d = engine.upload(args, dev)
        # decode_core launches 64 kernels on a standard stream
        ms = cuda_ms(lambda: engine.decode_core(d, dtabs), 10)
        b2b = cuda_ms(lambda: engine.decode_core(d, dtabs), 20, queued=False)
        t = time.perf_counter()
        yaik_tpu_torch.decode_image(stream, bank, device="cuda")
        e2e_ms = (time.perf_counter() - t) * 1e3
        mpix = args.height * args.width / 1e6
        print(f"time decode {n} {args.width}x{args.height}: device "
              f"{ms:.4f} ms/decode ({mpix / ms * 1e3:.1f} MPix/s), "
              f"back-to-back with host dispatch {b2b:.4f} ms/decode "
              f"({mpix / b2b * 1e3:.1f} MPix/s), host plan+pack "
              f"{host_ms:.2f} ms, decode_image wall {e2e_ms:.2f} ms "
              f"[{card}]")
    for n in ("img512", "bench_4k"):       # the standard decode's forms
        d = ops[n]
        mpix = d.height * d.width / 1e6
        for label, flags in (("split", {}),
                             ("fused", dict(t3_d1=True, grad_final=True)),
                             ("t3_d1 only", dict(t3_d1=True)),
                             ("grad_final only", dict(grad_final=True)),
                             ("fused", dict(t3_d1=True, grad_final=True)),
                             ("split", {})):
            ms = cuda_ms(lambda: engine.decode_core(d, dtabs, **flags), 10)
            b2b = cuda_ms(lambda: engine.decode_core(d, dtabs, **flags), 20,
                          queued=False)
            print(f"time decode {n} {d.width}x{d.height} {label} form: "
                  f"device {ms:.4f} ms/decode ({mpix / ms * 1e3:.1f} "
                  f"MPix/s), back-to-back with host dispatch {b2b:.4f} "
                  f"ms/decode ({mpix / b2b * 1e3:.1f} MPix/s) [{card}]")

    bounds = {}

    def time_kernel(name: str, label: str, a: tuple, n_kernel: int = 50,
                    n_plain: int = 5) -> tuple:
        """(kernel, plain) ms per call, timed plain, kernel, kernel, plain;
        the plain version launches up to ~180 kernels."""
        fn = getattr(kernels, name)
        plain = getattr(kernels, f"{name}_plain")
        p1 = cuda_ms(lambda: plain(*a), n_plain)
        k1 = cuda_ms(lambda: fn(*a), n_kernel)
        k2 = cuda_ms(lambda: fn(*a), n_kernel)
        p2 = cuda_ms(lambda: plain(*a), n_plain)
        print(f"time {name} {label}: kernel {k1:.4f} / {k2:.4f} ms, plain "
              f"{p1:.4f} / {p2:.4f} ms (plain, kernel, kernel, plain) "
              f"[{card}]")
        return (k1 + k2) / 2, (p1 + p2) / 2

    for n, d in ops.items():
        vc = kernels.t3_merged_d1(*d1_args(d))
        calls = {"grad_plane": (d.corners, d.code4),
                 "grad_plane_final": (d.corners, d.code4, vc),
                 "t3_merged": t3_args(d), "t3_merged_d1": d1_args(d)}
        # int32 operations per output pixel, roughly: the bilinear's 3
        # channels, the two layers' resolve, and the d1 epilogue
        px_ops = {"grad_plane": 40, "grad_plane_final": 50, "t3_merged": 40,
                  "t3_merged_d1": 80}
        for name, a in calls.items():
            t = time_kernel(name, n, a)
            if n == "bench_4k":
                kms[name] = t
                out = getattr(kernels, name)(*a)
                reads = [x for x in a if isinstance(x, torch.Tensor)]
                bounds[name] = bound(reads, [out], out.numel() * px_ops[name],
                                     "i32")

    fam_time = [(n, fam[n], fplans[n], {}) for n in FAMILIES
                + ["crafted_3layer", "sprite256"]]
    fam_time += [(f"{n} per-pass 2DTL", fam[n], fplans[n],
                  {"t2_form": "passes"}) for n in ("bench_2d512",
                                                   "corr2d128.2d")]
    fam_time.append(("bench_4k per-pass T3", streams["bench_4k"],
                     plans["bench_4k"], {"t3_form": "passes"}))
    for label, stream, plan, forms in fam_time:
        t = time.perf_counter()
        args = pack.plan_to_args(planner.build_plan(
            stream, bank.expanded, bank.expanded2d), lut, dtabs.lut2, **forms)
        host_ms = (time.perf_counter() - t) * 1e3
        d = engine.upload(args, dev)
        ms = cuda_ms(lambda: engine.decode_core(d, dtabs), 5)
        b2b = cuda_ms(lambda: engine.decode_core(d, dtabs), 10, queued=False)
        t = time.perf_counter()
        engine.decode_plan(plan, dtabs, **forms)
        e2e_ms = (time.perf_counter() - t) * 1e3
        mpix = args.height * args.width / 1e6
        print(f"time decode {label} {args.width}x{args.height}: device "
              f"{ms:.4f} ms/decode ({mpix / ms * 1e3:.1f} MPix/s), "
              f"back-to-back with host dispatch {b2b:.4f} ms/decode "
              f"({mpix / b2b * 1e3:.1f} MPix/s), host plan+pack "
              f"{host_ms:.2f} ms, decode wall (plan in hand) {e2e_ms:.2f} ms "
              f"[{card}]")
    img512p = engine.upload(pack.plan_to_args(plans["img512"], lut,
                                              t3_form="passes"), dev)
    new_kernels = [
        ("lut_pass", "img512 T3 4x4 pass",
         pass_args(tab, img512p.t3_passes[-1], 512, 512)),
        ("lut_pass", "bench_4k T3 16x8 pass",
         pass_args(tab, pass4k.t3_passes[0], *hw4k)),
        ("lut_pass", "bench_4k T3 4x4 pass",
         pass_args(tab, pass4k.t3_passes[-1], *hw4k))]
    new_kernels += [("t2_merged", f"synthetic {label} layers",
                     (dtabs.tab2, lay.idx16, lay.cols, lay.accept, lay.rows))
                    for label, lay in synth.items() if label != "64x64"]
    for name, label, a in new_kernels:
        t = time_kernel(name, label, a)
        if "4x4" in label and "bench_4k" in label or "3840" in label:
            kms[name] = t
            out = getattr(kernels, name)(*a)
            reads = [x for x in a if isinstance(x, torch.Tensor)]
            if name == "lut_pass":     # a tile the pass leaves has no index
                reads[1] = reads[1][reads[3] != 0]        # bytes to read
            bounds[name] = bound(reads, [out], out.numel()
                                 * (20 if name == "lut_pass" else 45), "i32")

    for n in ("img512", "bench_4k"):
        img = images[n]
        planes = planes_of(img, dev)

        def score_on_device():
            claims = torch.zeros(planes.shape, dtype=torch.bool, device=dev)
            scoring.gradient_all(planes, claims, 3)
            pipeline.tile3d_all(planes, claims, tabs)
        ms = cuda_ms(score_on_device, 1)     # ~650 launches a call
        b2b = cuda_ms(score_on_device, 3, queued=False)
        accepts, t3 = api.score_image(img, bank3d, "cuda")
        t = time.perf_counter()
        api.emit_image(img, accepts, t3)
        emit_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        yaik_tpu_torch.encode_image(img, bank3d, device="cuda")
        e2e_ms = (time.perf_counter() - t) * 1e3
        mpix = img.shape[0] * img.shape[1] / 1e6
        print(f"time encode {n} {img.shape[1]}x{img.shape[0]}: scoring "
              f"device {ms:.3f} ms ({mpix / ms * 1e3:.1f} MPix/s), "
              f"back-to-back with host dispatch {b2b:.3f} ms "
              f"({mpix / b2b * 1e3:.1f} MPix/s), host emission + zstd "
              f"{emit_ms:.2f} ms, encode_image wall {e2e_ms:.2f} ms [{card}]")
        if n == "bench_4k":           # one warm scoring call, by kernel
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                score_on_device()
                torch.cuda.synchronize()
            rows = sorted(((ev.device_time_total / 1e3, ev.count, ev.key)
                           for ev in prof.key_averages()
                           if ev.device_time_total > 0), reverse=True)
            print(f"profile encode {n} scoring: device "
                  f"{sum(r[0] for r in rows):.3f} ms in "
                  f"{sum(r[1] for r in rows)} kernel launches, by name "
                  f"[{card}]")
            for dms, cnt, key in rows[:12]:
                print(f"  profile {dms:.3f} ms x{cnt} {key[:100]}")

    # the encode kernels on every 4K pass (the sums form, off the encode
    # path, on the 4x4 pass only), with the bounds of this pass's work:
    # float32 operations, score48 7 per point distance of an alive pixel
    # (3 FMAs and a min), E*48*8 of them; values48 9 per distance, to the
    # 120 window points of every LUT for an alive pixel and to the chosen
    # window's points for every pixel. The bytes are those the function
    # needs: c and tiles of alive pixels only (a dead pixel's reach no
    # output), and for values48 the mode48 row, mn and d of a tile with an
    # alive pixel but one mode48 word of an all-dead tile (its type word's);
    # a_c, b_c, alive and idx of every pixel; pts in full and the factors
    # of the 120 window points.
    E = tabs.qpts.shape[0]
    for (n, sx, sy), (c, args) in enc_args.items():
        if n != "bench_4k":
            continue
        alive = args[1]
        T, P = alive.shape
        n_alive = float(alive.sum())
        n_live = float(alive.any(1).sum())
        label = f"{n} pass {1 << sx}x{1 << sy}"
        print(f"encode {label}: {n_alive / alive.numel():.4f} of the pixels "
              f"alive, {n_live / T:.4f} of the tiles with an alive pixel")
        mode = kernels.score48_mode(c, alive, tabs.qpts)
        v_out = kernels.values48(*args)
        window_pts = (64 >> (3 - (v_out[1] >> 14))).sum() * P
        score_ops = n_alive * E * 48 * 8 * 7
        v_ops = (n_alive * E * 120 + float(window_pts)) * 9
        _, _, a_c, b_c, _, _, _, pts, _ = args
        v_bytes = (nbytes(a_c, b_c, alive, pts, *v_out)
                   + n_alive * 12 + n_live * (E * 4 + 24)
                   + (T - n_live) * 4 + E * 120 * 12)
        b = {"score48_mode": bound([], [], score_ops, "f32",
                                   n_alive * 12 + nbytes(alive, tabs.qpts,
                                                         mode)),
             "values48": bound([], [], v_ops, "f32", v_bytes)}
        # the earlier counts: every tensor read in full, and before the
        # redesign every pixel x E x 120 points as well
        full = bound(list(args), list(v_out), v_ops, "f32")
        old = bound(list(args), list(v_out), T * P * E * 120 * 9, "f32")
        timed = [("score48_mode",
                  lambda: kernels.score48_mode(c, alive, tabs.qpts),
                  lambda: kernels.score48_mode_plain(c, alive, tabs.qpts)),
                 ("values48", lambda: kernels.values48(*args),
                  lambda: kernels.values48_plain(*args))]
        if (sx, sy) == (2, 2):
            sums = kernels.score48(c, alive, tabs.qpts)
            # the sums form: c, alive and qpts read, 1.19 GB of sums written
            b["score48"] = bound([c, alive, tabs.qpts], [sums], score_ops,
                                 "f32")
            del sums
            timed.insert(0, (
                "score48", lambda: kernels.score48(c, alive, tabs.qpts),
                lambda: kernels.score48_plain(c, alive, tabs.qpts)))
        for name, fn, plain in timed:
            p1 = cuda_ms(plain, 1, queued=False)
            k1 = cuda_ms(fn, 20)
            k2 = cuda_ms(fn, 20)
            p2 = cuda_ms(plain, 1, queued=False)
            extra = (f"; every tensor in full {full[0]:.4f} ms ({full[1]}), "
                     f"every pixel x E x 120 points {old[0]:.4f} ms "
                     f"({old[1]})" if name == "values48" else "")
            print(f"time {name} {label}: kernel {k1:.4f} / {k2:.4f} ms, "
                  f"plain {p1:.4f} / {p2:.4f} ms (plain, kernel, kernel, "
                  f"plain); bound {b[name][0]:.4f} ms ({b[name][1]}), "
                  f"{b[name][0] / ((k1 + k2) / 2):.0%} of it{extra} [{card}]")
            if (sx, sy) == (2, 2):
                kms[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
                bounds[name] = b[name]

    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": kms[name][0], "plain_ms": kms[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         # no single PyTorch call computes any of these functions
         "library_ms": None}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
