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
  against their digests; the 4K stream's pixels against the port's CPU
  decode (its kernel path equals the plain path pass by pass: each 4K
  pass's kernels are held to their plain versions on the kernel path's own
  operands).
- batch, spatial and corpus decode through `yaik_tpu_torch.parallel.batch`:
  `decode_batch` on eight batches (img512 and img512b x 8, split and
  fused; bench_rgba512 x 4; the five alpha cases, alpha left to the host;
  img64 with the crafted 3-layer stream, the per-pass T3 form;
  corr2d128.2d x 4; gradpair192.gp x 2; bench_ucol512 x 2), each kernel
  launched as often per batch as one image of it needs, every image equal
  to `decode_image`'s and to its golden or digest, and four mixed batches
  refused; `decode_spatial` of bench_4k in 4 bands, against its digest;
  `decode_corpus` of 52 streams of four sizes in a shuffled order (its
  64² batch mixes alpha with no alpha), one planner thread and all host
  cores, each equal to `decode_image`'s.
- batched, compacted encode through `yaik_tpu_torch.encoder.batch`:
  `encode_batch` of img512, img512b and six seeded variants (B = 8), with
  `score48_mode` and `values48` launched once per 3D pass for the batch
  and held against their plain versions on the B * C compacted operands
  of its 4x4 pass; `encode_corpus` of 16 images in a shuffled order
  (10 x 512², a short second batch; 5 x 128² with a noise image past the
  default caps, which grow; the 3840x2160 image, a batch of one); and
  `encode_image_banded` of the 4K image in bands of 544 rows, every
  stream equal to `encode_image`'s.
- RGBA encode and the passes the reference leaves disabled through
  `yaik_tpu_torch.encode_image(..., device="cuda")`: the RGBA decode of
  bench_rgba512, sprite256 and a 2048x2048 sprite sheet tiled from it; each
  of UCOL, SMAP, 2D (tests/fixtures/Bank2D), PLNT and plane gradients alone
  on img512 and corr2d128, and all of them together (on img512 all but
  plane gradients, which raise the reference's RuntimeError there, on the
  card and on the CPU path alike). Each stream equals the CPU path's bytes
  (`score_image(device="cpu")` + `emit_image`, which is what
  `encode_image(device="cpu")` runs, the scoring on a thread beside phases
  2-3d; the 2048² sheet's twin scores with the plain versions on the card,
  as its CPU scoring would outlast the run) and decodes on the card to the
  CPU-path decode's pixels, the alpha channel back as the source's where
  the alpha chunk is 8-bit; `encode_corpus` of a mixed RGB/RGBA corpus equals
  `encode_image`; every PLNT plane (`pack.plnt_args` +
  `engine.decode_plnt_plane`) on the card equals its CPU twin.
- LUT-bank mining through `yaik_tpu_torch.encoder.mining`: `mine_bank` of
  img512 and img512b and `mine_bank2d` of corr2d128 and img128 on the card,
  one `covers` and one `covers2d` launch each, files equal to the
  `device="cpu"` run's, with the live-point and counted-pixel shares of
  the clouds `mine_bank2d` captured. `covers` and `covers2d` are held
  against their plain versions at corpus scale (k = 256 candidates, n =
  50,000 seeded clouds, whose shares are printed beside) and timed there,
  `covers2d` also on tests/torch_covers.py's edge operands (empty and full
  candidates and tiles, interleaved slots, i32 coordinates up to 4096,
  every gate).
- the command line, `python -m yaik_tpu_torch`, in subprocesses from the
  checkout's root on the card: `encode --profile --stats` of img512, the
  2048x2048 sheet and the 3840x2160 image, each stream equal to
  `encode_image`'s in this run; `decode --profile` of img512, bench_4k
  (split, and fused with `--t3-d1 --grad-final`), bench_2d512 with
  `--lut2d` and bench_rgba512, against the goldens and digests; `--trace`
  of the 4K encode and decode, whose torch.profiler traces must hold the
  CUDA kernels of `score48_mode` and `values48` (6 each) and of
  `grad_plane` and `t3_merged` (1 each); `mine-report` of img512 +
  img512b, the mined files equal to the mining phase's and the report's
  bpp and PSNR to an in-process encode and decode of the corpus; `stats`
  and `lut` against the in-process calls. Each command's wall and stage
  report is printed; `lut`, the 4K encode and decode and mine-report run
  alone, the others together.
- the host engines and the C library against the card, in this process:
  `decode_image(engine="host")` (the numpy reference decoder, which shares
  no code with the kernels) of bench_4k, img512, img512b, bench_2d512,
  bench_rgba512, bench_ucol512, gradpair192.gp and the crafted 3-layer
  stream, and the C-ABI library `libyaik_tpu` (built here with g++ by
  `native.capi`) on the same streams, each equal to the card's
  `decode_image` split and fused; `encode_image(engine="host")` of img512
  (on a thread beside the command-line phase) byte-equal to
  `encode_image(device="cuda")` in this run (the same zstd on both sides);
  `mine_bank(engine="host")` of img512 + img512b writing the mining phase's
  files; `python -m yaik_tpu_torch decode|encode --engine host` of img512
  against the card's pixels and bytes. The walls printed: host decode, C
  library and the card's decode_image (split, fused) of bench_4k and
  img512; the host encode against encode_image on the card; load_bank on
  the device path, which builds none of the host scorer's maps.
- the emission's zstd pool and the entry point `entry()`: the 4K
  `encode_image` with its zstd batch on the calling thread and on the pool
  (serial, pool, pool, serial) in this process, each stream equal to phase
  3b's, with its `encode:zstd-flush` stage, the batch's stream count and
  its largest stream's compress time (the flush's floor), the wall and the
  process's RSS; phase 3d's 16-image corpus on 8 emission threads, equal
  to phase 3d's streams; and `yaik_tpu_torch.entry.entry()` on img128's
  stream and LutFile.lut on the card, its `fn(*example_args)` equal to
  img128's golden with the launches of img128's split decode.
- the split over a list of devices (`devices=`, the JAX package's
  `mesh=`): `yaik_tpu_torch.entry.dryrun_multichip(4, devices=[cuda:0] *
  4)`, and over `parallel.batch.data_devices()` where the machine has
  several cards: the JAX package's seven axes (batch, spatial, RGBA, 2DTL
  and corpus decode, the split encode-scoring blob, the banded encode),
  each against its golden or unsplit twin, with each axis's launches per
  device, every kernel an axis reaches launched at least once a slice
  (on one card the slices run one after another: the split and the join,
  not scaling); and the walls of the 52-stream `decode_corpus` and the
  16-image `encode_corpus` over `[cuda:0] * 2`, the slices dispatched
  from the calling thread and from a thread each, against
  `device="cuda:0"`, least of 3.
- the image sides no fixture has (tests/torch_streams.py's EDGE_CROPS):
  16 px wide (16x16, 24x16, 32x16, 128x16 of img128, 64x16 RGBA of
  sprite256) and w % 16 == 8 (128x120, 56x72, 64x24 of img128, 96x40 RGBA
  of sprite256): `encode_image` and `decode_image` (split and fused) on the
  card, launches counted against what the operands call for; each stream
  equal to `encode_image(device="cpu")`'s, to the emission's with the host
  library off, to a second call's and to `encode_batch` of two copies;
  each decode equal to the fused one, `decode_batch` of two copies, the
  host decoder, the C library and tests/fixtures/edge_digests.json; and
  `score48_mode` and `values48` against their plain versions on the
  16-wide crops' dense operands, all six passes.
The decode kernels are held against their plain versions on a batch too
(B = 4: img512, img512b and the RGB of bench_rgba512 and bench_2d512, and
random operands; each image of a batch against its own unbatched call,
B = 1 against the unbatched call; 72 images of 3840x2160, past 2^31 bytes
of plane). The encode kernels (`score48`, `score48_mode` and `values48`) are held
against their plain versions on all six 3D passes of img512 and of the 4K
image, on random operands (P 16-128, E up to 128, wild dead pixels in mixed
tiles), on patterns with ties and on a bank no tile takes; the encode run
shows `score48_mode` and `values48` launched once per 3D pass and the sums
form `score48` not at all. The gradient stage's kernel (`grad_score`) is
held against its plain version on img512, the 4K image, the 2048² sheet,
seeded edge shapes with and without random claims, batches of 4 and 8,
and reject factors 0, 3, 40 and -1, 255, 300, 2^31 - 1 (the ends of the
wrapper's clamp and past them), then timed at 4K in turns with its plain
version and with its earlier design (tests/grad_score_cta.cu, built alone).
Then the decodes, the encode and each kernel against its plain version are
timed with CUDA events (`score48_mode` and `values48` on all six 4K
passes, the sums form and the plain versions on the 4x4 pass, beside the
bounds of each pass's work), torch.profiler sums one warm 4K scoring call
by kernel name, and the batch path is timed: the core's device time per
image at B = 1, 4, 16 and 64 (512², split and fused), each decode kernel
on a batch of 16 against 16 unbatched calls, the upload of a B = 16 batch
(and what a pinned copy of its bytes would cost), decode_batch by stage,
and decode_corpus end to end (MPix/s, images/s). So is the batch encode:
device scoring per 512² image at B = 1, 4 and 16 (queued, back-to-back,
and the profiler's kernel sum), the scoring cap against dense scoring
(the 4x4 pass's operand stage and all six 3D passes; B = 16 512² and the
4K image), the transients' peak per pixel, the bytes each download form
takes per image, and encode_corpus end to end with no emission threads
and one per host core (MPix/s, images/s, and the host's time in
dispatch, waiting on the card and emission).
A kernel's launches are its wrapper's calls: a `values48` call runs three
CUDA kernels (table packing, decision, idx).

The last lines are the card as nvidia-smi names it, one JSON line with the
kernels (time, plain time, the card's least time for the same work and what
bounds it, the earlier design's time where one is kept; each kernel's
launches summed over the main-path runs, for the encode kernels the
`encode_image` runs and the batch encode runs, for `covers` and `covers2d`
the mining run), and
`{"ok": true, "device": {...}}`. Any failure raises, and the
script exits non-zero; so does a run without a GPU, where it prints no
result.
"""
from __future__ import annotations

import atexit
import dataclasses
import json
import os
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
ENCODE_KERNELS = ("grad_score", "score48", "score48_mode", "values48")
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
    # the encoder's gradient stage, the 7 passes in one launch: an XLA
    # program on the TPU (no Pallas kernel), a hand kernel here
    "grad_score": ("yaik_tpu_torch/ops/csrc/grad_score.cu",
                   "yaik_tpu/encoder/jax_scoring.py:112"),
    # the LUT-bank miner's coverage matrices: XLA functions on the TPU (no
    # Pallas kernel), a hand kernel here
    "covers": ("yaik_tpu_torch/ops/csrc/covers.cu",
               "yaik_tpu/encoder/mining.py:79"),
    "covers2d": ("yaik_tpu_torch/ops/csrc/covers.cu",
                 "yaik_tpu/encoder/mining.py:247"),
}
MINE_KERNELS = ("covers", "covers2d")
# the corpus scale of the miner's coverage matrix (mining.py's docstring):
# k candidate clouds against n captured tiles
K_MINE, N_MINE = 256, 50_000
# the card's peaks (NVIDIA H100 SXM data sheet, dense): HBM bytes/s, float32
# outside the tensor cores, and int32 (64 lanes per SM per clock, half the
# float32 rate)
HBM_BPS = 3.35e12
PEAK_OPS = {"f32": 67e12, "i32": 33.5e12}


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def cuda_ms(fn, iters: int, queued: bool = True, warm: bool = True
            ) -> float:
    """Mean device milliseconds per call over `iters` back-to-back calls,
    by CUDA events, after warm-up (`warm`; a plain version that takes
    seconds a call is timed cold). With `queued`, the stream first sleeps
    on the card for twice the host time the calls take to enqueue, so the
    events time the device work alone (the calls must then launch fewer
    than ~1000 kernels in all, or the host blocks on the full launch
    queue); without it they also time the host's dispatch where the card
    waits for it."""
    if warm:
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
    if got.numel() == 0:
        return 0
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


def _arrays(args) -> list:
    """Every array of a DecodeArgs record, nested records included."""
    out = []
    args.map(out.append)
    return out


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
    t0 = time.perf_counter()

    def lap(phase: str) -> None:
        print(f"phase {phase} starts at {time.perf_counter() - t0:.1f} s")
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]

    lap("1")
    # -- phase 1: the card, the host library and the kernel build ----------
    import yaik_tpu_torch
    from PIL import Image
    import torch_covers
    import torch_time_grad_score as time_grad_score
    from torch_streams import (craft_t3_stream, d1_operands, digest,
                               ramp_planes, saturated_planes, synth_t2_pass)
    from yaik_tpu_torch import native
    from yaik_tpu_torch.decoder import engine, pack, planner
    from yaik_tpu_torch.encoder import api, pipeline, scoring, tables
    from yaik_tpu_torch.encoder import bank as bankmod
    from yaik_tpu_torch.encoder import batch as ebatch
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
    # phase 3e's sources (bench_rgba512's: its CPU decode, which phase 3e
    # holds equal to the card's), and the CPU path's scoring of all but the
    # 2048² sheet on a thread beside phases 2-3d: it takes tens of seconds
    # a 512² image on the card's host, and torch's CPU ops release the GIL
    from concurrent.futures import ThreadPoolExecutor
    sprite = np.asarray(Image.open(FIX / "sprite256.png"))
    enc_src = {
        "bench_rgba512": np.ascontiguousarray(yaik_tpu_torch.decode_image(
            fam["bench_rgba512"], bank, device="cpu")),
        "sprite256": sprite,
        "sheet2048": np.ascontiguousarray(np.tile(sprite, (8, 8, 1))),
        "img512": images["img512"],
        "corr2d128": np.asarray(Image.open(FIX / "corr2d128.png"))}

    def cpu_scoring(rgb: np.ndarray) -> tuple:
        t = time.perf_counter()
        return (api.score_image(rgb, bank3d, "cpu"),
                time.perf_counter() - t)
    cpu_pool = ThreadPoolExecutor(1)
    cpu_jobs = {n: cpu_pool.submit(cpu_scoring, rgb)
                for n, rgb in enc_src.items() if n != "sheet2048"}

    lap("2")
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

    lap("2a")
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

    lap("2c")
    # -- phase 2c: the decode kernels on a batch: one launch for B images,
    # held against the batched plain version, each image of the batch
    # against the unbatched kernel on its own operands, and B = 1 against
    # the unbatched call ----------------------------------------------------
    def check_batch(name, label, batched, axes) -> torch.Tensor:
        """`axes`: per operand, the axis of its batch (0, or 1 behind the
        layer / row axis), None for one shared by the batch."""
        got = check(name, f"{label}, batch of {got_b(batched, axes)}",
                    *batched)
        fn = getattr(kernels, name)
        for b in range(got.shape[0]):
            e = max_abs_err(got[b], fn(*(
                x if ax is None else x.select(ax, b).contiguous()
                for x, ax in zip(batched, axes))))
            err[name] = max(err[name], e)
            if e:
                raise AssertionError(f"{name} {label}: image {b} of the "
                                     "batch differs from its own call")
        one = fn(*(x if ax is None else x.narrow(ax, 0, 1).contiguous()
                   for x, ax in zip(batched, axes)))
        if one.shape[0] != 1 or max_abs_err(one[0], got[0]):
            raise AssertionError(f"{name} {label}: B = 1 differs")
        return got

    def got_b(batched, axes) -> int:
        return next(x.shape[ax] for x, ax in zip(batched, axes)
                    if ax is not None)

    GRAD, LAYERS, PASS = (0, 0, 0), (None,) + (1,) * 4, (None,) + (0,) * 4
    D1 = LAYERS + (1, 1, 1, None, None)
    from yaik_tpu_torch.parallel import batch
    r4 = ["img512", "img512b", "bench_rgba512", "bench_2d512"]
    r4_plans = [plans[n] if n in plans else fplans[n] for n in r4]

    def rgb_only(a):
        return dataclasses.replace(a, alpha=None, t2_layers=None,
                                   t2_passes=None)
    b4 = engine.upload(pack.stack_args([rgb_only(pack.plan_to_args(
        p, lut, dtabs.lut2)) for p in r4_plans]), dev)
    label = "real " + ", ".join(r4)
    check_batch("grad_plane", label, (b4.corners, b4.code4), GRAD)
    check_batch("t3_merged", label, t3_args(b4), LAYERS)
    vc4 = check_batch("t3_merged_d1", label, d1_args(b4), D1)
    check_batch("grad_plane_final", label, (b4.corners, b4.code4, vc4), GRAD)
    p4 = engine.upload(pack.stack_args([rgb_only(pack.plan_to_args(
        p, lut, dtabs.lut2, t3_form="passes")) for p in r4_plans]), dev)
    for p in p4.t3_passes:
        if p is not None:
            check_batch("lut_pass", f"{label}, T3 pass {1 << p.shift[0]}x"
                        f"{1 << p.shift[1]}", pass_args(tab, p, 512, 512),
                        PASS + (None,) * 6)
    # random: four images each, a 16-row pass grid ending short of 40 rows
    H, W = 40, 1288
    corners = torch.from_numpy(rng.integers(0, 1 << 24, (
        4, 7, H // 4 + 1, W // 4 + 1)).astype(np.int32)).to(dev)
    code4 = torch.from_numpy(rng.integers(0, 8, (4, H // 4, W // 4)).astype(
        np.uint8)).to(dev)
    vc = torch.from_numpy(rng.integers(0, 1 << 27, (4, H, W)).astype(
        np.int32)).to(dev)
    check_batch("grad_plane", f"random {H}x{W}", (corners, code4), GRAD)
    check_batch("grad_plane_final", f"random {H}x{W}", (corners, code4, vc),
                GRAD)
    G = (H // 4) * (W // 4)
    lay = [x.reshape(2, 4, G, *x.shape[2:]).contiguous()
           for x in t3_random(4 * G)]
    d1 = [torch.from_numpy(x.reshape(x.shape[0], 4, G).copy()).to(dev)
          for x in d1_operands(rng, 4 * G)]
    check_batch("t3_merged", f"random {H}x{W}", (tab, *lay), LAYERS)
    check_batch("t3_merged_d1", f"random {H}x{W}", (tab, *lay, *d1, H, W),
                D1)
    lays = [pack.t2_merge_layers(synth_t2_plan(512, 512, 100 + b),
                                 dtabs.lut2) for b in range(4)]
    check_batch("t2_merged", "synthetic overlapping 512x512 layers",
                (dtabs.tab2, *(torch.from_numpy(np.stack(
                    [getattr(x, f) for x in lays], 1)).to(dev)
                    for f in pack.Layers.ARRAYS)), LAYERS)
    for sx, sy in ((4, 3), (2, 2)):
        nty, ntx = H >> sy, W >> sx
        g = nty * ntx
        check_batch("lut_pass", f"random {1 << sx}x{1 << sy} tiles, {H}x{W}",
                    (tab, *(torch.from_numpy(x).to(dev) for x in (
                        rng.integers(0, 128, (4, g, 1 << (sx + sy))).astype(
                            np.uint8),
                        rng.integers(0, 256, (4, g, 6)).astype(np.uint8),
                        (rng.integers(0, 2, (4, g)) * 7).astype(np.uint8),
                        rng.integers(0, lut.tab.shape[0], (4, g)).astype(
                            np.int32))),
                     nty, ntx, 1 << sy, 1 << sx, H, W), PASS + (None,) * 6)
    # 64-bit per-image offsets: 72 planes of 3840x2160 are 2.22 GiB, past
    # 2^31 bytes; the first image and the last (random operands) are held
    # against their own calls
    d4k, (H4, W4) = ops["bench_4k"], hw4k
    n = 72

    def rand_last(x, hi):
        """`x` [1, ...] repeated n - 1 times, then one random image."""
        last = torch.from_numpy(rng.integers(0, hi, x.shape).astype(
            np.int32 if x.dtype == torch.int32 else np.uint8)).to(dev)
        return torch.cat([x.expand(n - 1, *x.shape[1:]), last])
    big = [rand_last(d4k.corners[None], 1 << 24),
           rand_last(d4k.code4[None], 8)]
    for name in ("grad_plane", "grad_plane_final"):
        if name == "grad_plane_final":
            big.append(rand_last(torch.zeros((1, H4, W4), dtype=torch.int32,
                                             device=dev), 1 << 27))
        got = getattr(kernels, name)(*big)
        torch.cuda.synchronize()
        e = max(max_abs_err(got[b], getattr(kernels, name)(
            *(x[b] for x in big))) for b in (0, n - 1))
        err[name] = max(err[name], e)
        print(f"check {name} batch of {n} images of {W4}x{H4} "
              f"({got.numel() * 4 / 2 ** 30:.2f} GiB of output): first and "
              f"last image max_abs_err {e}")
        if e:
            raise AssertionError(f"{name} breaks past 2^31 bytes")
        del got
    p = pass4k.t3_passes[-1]
    big = [rand_last(x[None], hi) for x, hi in (
        (p.packed, 128), (p.cols, 256), (p.chm, 2), (p.rows, 1000))]
    a = (tab, *big, *p.grid, 1 << p.shift[1], 1 << p.shift[0], H4, W4)
    got = kernels.lut_pass(*a)
    torch.cuda.synchronize()
    e = max(max_abs_err(got[b], kernels.lut_pass(
        *a[:1], *(x[b] for x in big), *a[5:])) for b in (0, n - 1))
    err["lut_pass"] = max(err["lut_pass"], e)
    print(f"check lut_pass batch of {n} 4x4 passes of {W4}x{H4} "
          f"({got.numel() * 4 / 2 ** 30:.2f} GiB of output): first and last "
          f"image max_abs_err {e}")
    if e:
        raise AssertionError("lut_pass breaks past 2^31 bytes")
    del big, got, a
    torch.cuda.empty_cache()

    lap("2b")
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

    # the gradient stage: grad_score against its plain version, the packed
    # accepts and the claims it leaves, on img512, the 4K image, the 2048²
    # sheet's RGB, seeded ramps broken by noise at the edge shapes (h or w
    # % 16 == 8, a band's 16k + 1 rows, shapes smaller than a tile) with
    # random claims, and a B = 8 batch of img512 variants
    def check_grad(label, planes, claims, rf=3):
        c_k, c_p = claims.clone(), claims.clone()
        got = kernels.grad_score(planes, c_k, rf)
        want = kernels.grad_score_plain(planes, c_p, rf)
        check_kernel("grad_score", label, [got, c_k], [want, c_p])
        print(f"  grad_score {label}: {int(got.sum())} of {got.numel()} "
              f"tiles accepted, {int((c_k & ~claims).sum())} claim bits set")

    def zeros_like(planes):
        return torch.zeros(planes.shape, dtype=torch.bool, device=dev)
    for n, img in (("img512", images["img512"]),
                   ("bench_4k", images["bench_4k"]),
                   ("sheet2048", enc_src["sheet2048"][..., :3])):
        p = planes_of(img, dev)
        check_grad(n, p, zeros_like(p))
    grng = np.random.default_rng(14)
    for h, w in ((40, 56), (88, 64), (64, 88), (545, 3840), (17, 1288),
                 (3, 5), (1, 17), (136, 264)):
        p = torch.from_numpy(ramp_planes(grng, 1, h, w)[0]).to(dev)
        check_grad(f"seeded ramps {h}x{w}", p, zeros_like(p))
        check_grad(f"seeded ramps {h}x{w}, random claims", p,
                   torch.from_numpy(grng.random(p.shape) < 0.03).to(dev))
    p = torch.from_numpy(saturated_planes(72, 88)).to(dev)
    check_grad("tiles only round6p's clamp at 255 accepts, 72x88, "
               "reject_factor 0", p, zeros_like(p), 0)
    p = torch.from_numpy(ramp_planes(grng, 4, 136, 264)).to(dev)
    for rf in (0, 3, 40):
        check_grad(f"B = 4 seeded ramps 136x264, random claims, "
                   f"reject_factor {rf}", p,
                   torch.from_numpy(grng.random(p.shape) < 0.03).to(dev), rf)
    # the reject factor at the ends of the wrapper's clamp to [-1, 255] and
    # past them (the plain version takes it as it is), on the batch and on
    # a band's 16k + 1 rows with w % 16 == 8
    edge = torch.from_numpy(ramp_planes(grng, 1, 545, 264)[0]).to(dev)
    for rf in (-1, 255, 300, 2 ** 31 - 1):
        check_grad(f"B = 4 seeded ramps 136x264, random claims, "
                   f"reject_factor {rf}", p,
                   torch.from_numpy(grng.random(p.shape) < 0.03).to(dev), rf)
        check_grad(f"seeded ramps 545x264, random claims, reject_factor "
                   f"{rf}", edge,
                   torch.from_numpy(grng.random(edge.shape) < 0.03).to(dev),
                   rf)
    p = ebatch._upload([np.roll(images["img512"] if i % 2 else
                               np.asarray(Image.open(FIX / "img512b.png")),
                               8 * i, axis=i % 2) for i in range(8)], dev)
    check_grad("B = 8 img512 / img512b rolled", p, zeros_like(p))

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

    lap("2e")
    # -- phase 2e: the miner's coverage kernels against their plain versions
    # at corpus scale, on seeded clouds: 3D tiles near the candidates (so
    # some are covered), 2D point sets of 1..64 points -------------------
    from yaik_tpu_torch.encoder import mining
    cover_args = {name: tuple(torch.from_numpy(a).to(dev) for a in arrs)
                  for name, arrs in torch_covers.corpus(K_MINE,
                                                        N_MINE).items()}
    for name, a in cover_args.items():
        got = check(name, f"k = {K_MINE}, n = {N_MINE} seeded clouds", *a)
        print(f"  {name}: {int(got.sum())} of {got.numel()} (candidate, "
              "tile) pairs covered")
    print("  covers2d operands: live-point share %.4f, counted-pixel share "
          "%.4f" % torch_covers.shares(*(x.cpu().numpy() for x in
                                         cover_args["covers2d"][1::2])))
    # covers2d on tests/torch_covers.py's edge operands: empty and full
    # candidates and tiles, tiles of 0..6 pixels, interleaved slots with
    # arbitrary pad values, i32 coordinates up to 4096; every gate on both
    # of the kernel's routes; k and n of 1 and past the blocks' shapes
    edge = [(33, 4097, case, 36) for case in torch_covers.CASES]
    edge += [(33, 130, case, gate) for case in ("seeded", "wide")
             for gate in torch_covers.GATES]
    edge += [(257, 1, case, 36) for case in ("seeded", "empty_tiles")]
    for k, n, case, gate in edge:
        a = [torch.from_numpy(x).to(dev)
             for x in torch_covers.operands(case, k, n, k + n)]
        check("covers2d", f"{case} k = {k}, n = {n}, gate {gate}", *a, gate)

    lap("3")
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

    lap("3a")
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

    lap("3c")
    # -- phase 3c: batch, spatial and corpus decode through the user's
    # entry points (yaik_tpu_torch.parallel.batch); each kernel launches as
    # often per batch as one image of it needs, whatever B is --------------
    src = {**streams, **fam}
    ref = {**outs, **fouts}           # decode_image's pixels of each stream
    alpha5 = [f"alpha64_{n}" for n in ("1bit", "6bit", "8bit", "const255",
                                       "sparse")]
    fused_flags = dict(t3_d1=True, grad_final=True)
    batch_runs = [("img512, img512b x 8, split", ["img512", "img512b"] * 8, {}),
                  ("img512, img512b x 8, fused", ["img512", "img512b"] * 8,
                   fused_flags),
                  ("bench_rgba512 x 4 (one alpha spec)", ["bench_rgba512"] * 4,
                   {}),
                  ("the five alpha64 cases (host alpha)", alpha5, {}),
                  ("img64 + crafted 3-layer (T3 passes)",
                   ["img64", "crafted_3layer"], {}),
                  ("corr2d128.2d x 4 (2D bank)", ["corr2d128.2d"] * 4, {}),
                  ("gradpair192.gp x 2", ["gradpair192.gp"] * 2, {}),
                  ("bench_ucol512 x 2", ["bench_ucol512"] * 2, {})]
    batch_launches = dict.fromkeys(DECODE_KERNELS, 0)
    one_args = {**std_args, **{n: a for n, a in fam_args.items()
                               if isinstance(n, str)}}
    for label, names, flags in batch_runs:
        bplans = [planner.build_plan(src[n], bank.expanded, bank.expanded2d)
                  for n in names]
        want = expected(batch.batch_operands(bplans, dtabs)[0], **flags)
        one = {n: expected(one_args[n], **flags) for n in names}
        if (label.endswith("(T3 passes)") and want["lut_pass"] != 6
                or not label.endswith("(T3 passes)")
                and any(w != want for w in one.values())):
            raise AssertionError(f"{label}: the batch calls for {want}, one "
                                 f"image for {one}")
        reset()
        out = batch.decode_batch([src[n] for n in names], bank,
                                 device="cuda", **flags)
        got = counts()
        print(f"launches in decode_batch {label} (B = {len(names)}): {got}")
        if got != want:
            raise AssertionError(f"decode_batch {label} launches {got}, "
                                 f"one image of it calls for {want}")
        for name, k in got.items():
            batch_launches[name] += k
        for b, n in enumerate(names):
            if not np.array_equal(out[b], ref[n]):
                raise AssertionError(f"decode_batch {label}: {n} differs "
                                     "from decode_image")
        for n in sorted(set(names)):
            hold(f"{n} in decode_batch {label}", out[names.index(n)], n)
    print(f"launches in the {len(batch_runs)} decode_batch runs: "
          f"{batch_launches}")
    for name, k in batch_launches.items():
        if k == 0:
            raise AssertionError(f"{name} was not launched by decode_batch")
    for names in (["img64", "img128"], ["img64", "alpha64_8bit"],
                  ["img64", "img64.ucol"], ["corr2d128.2d", "img128"]):
        try:
            batch.decode_batch([src[n] for n in names], bank, device="cuda")
        except ValueError as e:
            print(f"decode_batch {' + '.join(names)} raises ValueError: {e}")
        else:
            raise AssertionError(f"decode_batch accepted {names}")
    reset()
    spatial = batch.decode_spatial(streams["bench_4k"], bank, device="cuda",
                                   n_bands=4)
    got = counts()
    heights = [b.height for b in batch.split_plan_bands(plans["bench_4k"], 4)]
    groups = 1 + sum(a != b for a, b in zip(heights, heights[1:]))
    print(f"launches in decode_spatial bench_4k, bands of {heights} rows in "
          f"{groups} batches: {got}")
    if got["grad_plane"] != groups or got["t3_merged"] != groups:
        raise AssertionError(f"decode_spatial is not {groups} batches")
    hold("bench_4k by decode_spatial in 4 bands", spatial, "bench_4k")
    # a corpus of 52 streams of four sizes in a shuffled order; its 64^2
    # batch holds alpha beside no alpha, and five alpha specs
    corpus = (["img512", "img512b"] * 20 + alpha5 + ["img64"]
              + ["img128", "quilt128"] * 2 + ["bench_4k"] * 2)
    corpus = [corpus[i] for i in np.random.default_rng(6).permutation(
        len(corpus))]
    corpus_mpix = sum(ref[n].shape[0] * ref[n].shape[1] for n in corpus) / 1e6
    corpus_s = {}
    for workers in (1, os.cpu_count()):
        reset()
        t = time.perf_counter()
        res = batch.decode_corpus([src[n] for n in corpus], bank,
                                  batch_size=8, planner_workers=workers,
                                  device="cuda")
        corpus_s[workers] = time.perf_counter() - t
        if len(res) != len(corpus) or not all(
                np.array_equal(r, ref[n]) for r, n in zip(res, corpus)):
            raise AssertionError("decode_corpus differs from decode_image")
        print(f"decode_corpus of {len(corpus)} streams ({corpus_mpix:.2f} "
              f"MPix, batch_size 8) with {workers} planner threads: each "
              f"equal to decode_image, in input order; launches {counts()}")

    lap("3b")
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
    # one grad_score per gradient stage, one score48_mode and one values48
    # per 3D pass; the sums form is off the encode path
    want = {"grad_score": len(images), "score48": 0,
            "score48_mode": 6 * len(images), "values48": 6 * len(images)}
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
    # the 4K image's kernel path equals its plain path pass by pass: phase
    # 2b held each of the six passes' kernels to their plain versions on
    # the kernel path's own operands and claims
    img4k, stream4k = images["bench_4k"], encoded["bench_4k"]
    back = yaik_tpu_torch.decode_image(stream4k, bank, device="cuda")
    ok = np.array_equal(back, yaik_tpu_torch.decode_image(stream4k, bank,
                                                          device="cpu"))
    print(f"encode bench_4k: {len(stream4k)} bytes "
          f"({8 * len(stream4k) / img4k[..., 0].size:.3f} bits/pixel), "
          f"decode_image(cuda) {'equal to' if ok else 'DIFFERS from'} "
          f"decode_image(cpu), PSNR {psnr(back, img4k):.2f} dB vs the input")
    if not ok:
        raise AssertionError("the 4K stream decodes wrong on the card")

    lap("3d")
    # -- phase 3d: batched, compacted encode through the user's entry
    # points (yaik_tpu_torch.encoder.batch): grad_score runs once per batch,
    # score48_mode and values48 once per 3D pass per batch, whatever B is --

    def variant(img, i):
        """Corpus member i of a base image: itself for i < 2, else rolled
        by multiples of 8 (tile alignment kept) and flipped."""
        if i < 2:
            return img
        v = np.roll(img, 8 * ((i * 7) % 63 + 1), axis=1)
        v = np.roll(v, 8 * ((i * 5) % 63 + 1), axis=0)
        return np.ascontiguousarray(v[::-1] if i % 3 == 1 else
                                    v[:, ::-1] if i % 3 == 2 else v)

    enc_ref = {}

    def enc_want(key, img):
        """encode_image's stream of an image, on the card, once."""
        if key not in enc_ref:
            enc_ref[key] = yaik_tpu_torch.encode_image(img, bank3d,
                                                       device="cuda")
        return enc_ref[key]

    enc_ref["img512", 0] = encoded["img512"]
    enc_ref["bench_4k", 0] = encoded["bench_4k"]
    base512 = {"img512": images["img512"],
               "img512b": np.asarray(Image.open(FIX / "img512b.png"))}
    enc8 = [(("img512", "img512b")[i % 2], i) for i in range(8)]
    img_of = {k: variant(base512[k[0]], k[1]) for k in enc8}
    # twice: the first call starts from the default caps and grows them
    # where the images overflow them (one more dispatch of the batch); the
    # second starts from the caps learned
    cfg = api.EncoderConfig()
    ebatch._CAP_STATE.clear()
    dispatches = []
    for which in ("first", "second"):
        for name in ENCODE_KERNELS:
            getattr(kernels, name).launches = 0
        got = ebatch.encode_batch([img_of[k] for k in enc8], bank3d,
                                  device="cuda")
        enc_batch_launches = {name: getattr(kernels, name).launches
                              for name in ENCODE_KERNELS}
        learned = ebatch._CAP_STATE.get((512, 512, cfg.reject_factor))
        print(f"launches in the {which} encode_batch of img512, img512b and 6 "
              f"variants (B = 8): {enc_batch_launches}; caps learned "
              f"{learned} (default {pipeline.pass_caps(512, 512)})")
        n = enc_batch_launches["score48_mode"] // 6
        if (enc_batch_launches != {"grad_score": n, "score48": 0,
                                   "score48_mode": 6 * n, "values48": 6 * n}
                or n < 1 or which == "second" and n != 1):
            raise AssertionError("encode_batch does not launch grad_score "
                                 "once per batch and score48_mode and "
                                 "values48 once per 3D pass per batch")
        dispatches.append(n)
        for k, st in zip(enc8, got):
            if st != enc_want(k, img_of[k]):
                raise AssertionError(f"encode_batch: {k} differs from "
                                     "encode_image")
        for name, k in enc_batch_launches.items():
            launches[name] += k
    print(f"encode_batch B = 8 512x512: each stream equal to encode_image's "
          f"in both calls; the batch was scored {dispatches[0]} then "
          f"{dispatches[1]} times, each time one grad_score launch and one "
          "score48_mode and one values48 launch per 3D pass")

    # the kernels on the B * C compacted operands of the batch's 4x4 pass,
    # at the caps learned
    caps512 = ebatch._CAP_STATE.get((512, 512, cfg.reject_factor),
                                    pipeline.pass_caps(512, 512))
    planes8 = ebatch._upload([img_of[k] for k in enc8], dev)
    _, claims8 = ebatch._score_gradients(planes8, cfg)
    for (sx, sy), (scap, _) in zip(swizzle.TILE3D_PASS_ORDER[:-1],
                                   caps512[:-1]):
        scoring.tile3d_pass_b(planes8, claims8, tabs, sx, sy, scap)
    bo = scoring.tile3d_operands_b(planes8, claims8, 2, 2, caps512[-1][0])
    print(f"encode_batch B = 8 pass 4x4: cap {caps512[-1][0]} of "
          f"{512 * 512 // 16} tiles per image, alive-tile counts "
          f"{bo.alive_cnt.tolist()}; B * C = {bo.ops.c.shape[0]} rows")
    check_score_values("encode_batch B = 8 pass 4x4, B * C rows", bo.ops)
    del planes8, claims8, bo

    # a corpus of 16 in a shuffled order: 512^2 x 10 (a short second
    # batch), 128^2 x 5 with a noise image past the default caps, and the
    # 3840x2160 image, whose group is a batch of one under the ceiling
    noise = np.random.default_rng(11).integers(0, 256, (128, 128, 3),
                                               np.uint8)
    base_of = {**base512, "img128": np.asarray(Image.open(
        FIX / "img128.png")), "quilt128": np.asarray(Image.open(
            FIX / "quilt128.png")), "noise128": noise,
        "bench_4k": images["bench_4k"]}
    ckeys = ([(("img512", "img512b")[i % 2], i) for i in range(10)]
             + [("img128", 0), ("quilt128", 0), ("noise128", 0),
                ("img128", 2), ("quilt128", 3), ("bench_4k", 0)])
    ckeys = [ckeys[i] for i in np.random.default_rng(7).permutation(
        len(ckeys))]
    img_of.update({k: variant(base_of[k[0]], k[1]) for k in ckeys})
    corpus_imgs = [img_of[k] for k in ckeys]
    enc_mpix = sum(im.shape[0] * im.shape[1] for im in corpus_imgs) / 1e6
    ebatch._CAP_STATE.clear()
    for name in ENCODE_KERNELS:
        getattr(kernels, name).launches = 0
    got = ebatch.encode_corpus(corpus_imgs, bank3d, batch_size=8,
                               device="cuda")
    corpus_launches = {name: getattr(kernels, name).launches
                       for name in ENCODE_KERNELS}
    learned = ebatch._CAP_STATE.get((128, 128, cfg.reject_factor))
    print(f"encode_corpus of {len(ckeys)} images ({enc_mpix:.2f} MPix, "
          f"batch_size 8): launches {corpus_launches}; caps learned for "
          f"128x128 {learned} (default {pipeline.pass_caps(128, 128)})")
    if learned is None:
        raise AssertionError("the noise image did not make the caps grow")
    if 6 * corpus_launches["grad_score"] != corpus_launches["score48_mode"]:
        raise AssertionError("encode_corpus does not launch grad_score once "
                             "per batch scored")
    for k, st in zip(ckeys, got):
        if st != enc_want(k, img_of[k]):
            raise AssertionError(f"encode_corpus: {k} differs from "
                                 "encode_image")
    corpus3d = got                                  # phase 3i's reference
    back = yaik_tpu_torch.decode_image(got[ckeys.index(("bench_4k", 0))],
                                       bank, device="cuda")
    if not np.array_equal(back, yaik_tpu_torch.decode_image(
            stream4k, bank, device="cpu")):
        raise AssertionError("the corpus 4K stream decodes wrong")
    print("encode_corpus: each stream equal to encode_image's, in input "
          "order; the 4K stream decoded on the card equal to encode_image's "
          "4K stream decoded on the CPU")
    for name, k in corpus_launches.items():
        launches[name] += k
    for name in ENCODE_KERNELS:
        getattr(kernels, name).launches = 0
    t = time.perf_counter()
    banded = ebatch.encode_image_banded(img4k, bank3d, device="cuda",
                                        band_rows=544)
    band_launches = {name: getattr(kernels, name).launches
                     for name in ENCODE_KERNELS}
    print(f"encode_image_banded bench_4k, bands of 544 rows (544 x 3 + 528) "
          f"({time.perf_counter() - t:.2f} s): "
          f"{'equal to' if banded == stream4k else 'DIFFERS from'} "
          f"encode_image's stream; launches {band_launches}")
    if banded != stream4k:
        raise AssertionError("encode_image_banded differs from encode_image")
    if band_launches != {"grad_score": 4, "score48": 0, "score48_mode": 24,
                         "values48": 24}:
        raise AssertionError("encode_image_banded does not launch each "
                             "kernel once a band")
    for name, k in band_launches.items():
        launches[name] += k

    lap("3e")
    # -- phase 3e: RGBA encode and the passes the reference leaves disabled,
    # through encode_image on the card (counts from 0 before, read after);
    # then each stream against the CPU path's bytes, and decoded on the card
    # against the CPU-path decode ----------------------------------------
    from yaik_tpu_torch.decoder.reference import iter_chunks
    from yaik_tpu_torch.encoder import bank2d as bank2dmod
    from yaik_tpu_torch.format.headers import AlphaHeader, PlaneTile
    from torch_streams import rgba_case
    bank2d = bank2dmod.load_bank2d(str(FIX / "Bank2D"))
    if not np.array_equal(enc_src["bench_rgba512"],
                          fouts["bench_rgba512"]):
        raise AssertionError("bench_rgba512's CPU decode differs from the "
                             "card's")
    passes = ("enable_single_color", "enable_smooth_map", "enable_2d",
              "enable_plnt", "enable_plane_gradients")
    jobs = [(n, n, {}) for n in ("bench_rgba512", "sprite256", "sheet2048")]
    for n in ("img512", "corr2d128"):
        jobs += [(f"{n} {p[7:]}", n, {p: True}) for p in passes]
    jobs.append(("corr2d128 all passes", "corr2d128",
                 dict.fromkeys(passes, True)))
    # plane gradients on img512 raise the reference's RuntimeError (its
    # palette codec fails on the 2-byte stream of the RG pass, as in the JAX
    # package), so every pass together there is every other pass
    jobs.append(("img512 all passes but plane gradients", "img512",
                 dict.fromkeys(passes[:4], True)))

    def attempt(fn):
        try:
            return fn()
        except RuntimeError as e:        # compared like a stream below
            return e

    for name in ENCODE_KERNELS:
        getattr(kernels, name).launches = 0
    on_card, walls = {}, {}
    for label, n, kw in jobs:
        t = time.perf_counter()
        on_card[label] = attempt(lambda: yaik_tpu_torch.encode_image(
            enc_src[n], bank3d, device="cuda",
            config=api.EncoderConfig(**kw), bank2d=bank2d))
        walls[label] = time.perf_counter() - t
    pass_launches = {name: getattr(kernels, name).launches
                     for name in ENCODE_KERNELS}
    print(f"launches in the {len(jobs)} RGBA and disabled-pass encodes "
          f"({sum(walls.values()):.2f} s): {pass_launches}; encode_image "
          "wall on the card: " + ", ".join(f"{k} {v:.3f} s"
                                           for k, v in walls.items()))
    if pass_launches != {"grad_score": len(jobs), "score48": 0,
                         "score48_mode": 6 * len(jobs),
                         "values48": 6 * len(jobs)}:
        raise AssertionError("an RGBA or disabled-pass encode does not launch "
                             "grad_score once and score48_mode and values48 "
                             "once per 3D pass")
    for name, k in pass_launches.items():
        launches[name] += k

    # the CPU path: encode_image(device="cpu") is score_image(device="cpu")
    # then emit_image; the scoring reads no pass switch, so it runs once per
    # image (phase 1's thread). The 2048² sheet has 16 times img512's
    # pixels, too many for the CPU in this run: its twin scores with the
    # plain versions on the card, the CPU path's torch ops and arithmetic.
    t = time.perf_counter()
    cpu_scores, cpu_s = {}, {}
    for n, job in cpu_jobs.items():
        cpu_scores[n], cpu_s[n] = job.result()
    cpu_pool.shutdown()
    print("score_image(device=\"cpu\") on a thread beside phases 2-3d: "
          + ", ".join(f"{n} {s:.2f} s" for n, s in cpu_s.items())
          + f"; waited {time.perf_counter() - t:.2f} s for it here")
    cpu_scores["sheet2048"] = api.score_image(enc_src["sheet2048"], bank3d,
                                              "cuda", plain=True)
    for label, n, kw in jobs:
        t = time.perf_counter()
        twin = attempt(lambda: api.emit_image(
            enc_src[n], *cpu_scores[n], api.EncoderConfig(**kw),
            bank2d=bank2d))
        got = on_card[label]
        if isinstance(got, Exception) or isinstance(twin, Exception):
            same = str(got) == str(twin) and type(got) is type(twin)
            print(f"encode {label}: raises {type(got).__name__}({got}) on the "
                  f"card, {'and' if same else 'BUT NOT'} on the CPU path")
            if not same or n != "img512" or "gradients" not in label:
                raise AssertionError(f"encode {label} raised")
            continue
        px = yaik_tpu_torch.decode_image(got, bank, device="cuda")
        same_px = np.array_equal(
            px, yaik_tpu_torch.decode_image(got, bank, device="cpu"))
        tags = list(dict.fromkeys(tag.decode()
                                  for tag, _, _ in iter_chunks(got)))
        alpha8 = [AlphaHeader.unpack(body).parameters & 7
                  for tag, _, body in iter_chunks(got)
                  if tag == b"ALPM"] == [AlphaHeader.IS_8_BIT_FULL]
        alpha_ok = not alpha8 or np.array_equal(px[..., 3],
                                                enc_src[n][..., 3])
        where = " (plain versions on the card)" if n == "sheet2048" else ""
        print(f"encode {label} {'x'.join(map(str, enc_src[n].shape))}: "
              f"{len(got)} bytes, "
              f"{'equal to' if got == twin else 'DIFFERS from'} the CPU "
              f"path's{where}; decoded on the card "
              f"{'equal to' if same_px else 'DIFFERS from'} the CPU-path "
              f"decode; chunks {' '.join(tags)}"
              f"{'; 8-bit alpha back as the source' if alpha8 else ''} "
              f"({time.perf_counter() - t:.2f} s)")
        if not (got == twin and same_px and alpha_ok):
            raise AssertionError(f"encode {label} is wrong")

    # a mixed corpus: RGB and RGBA of one size share no batch (shape
    # groups), every stream equal to encode_image's on the card
    mixed = [enc_src["bench_rgba512"], images["img512"], sprite,
             *(rgba_case(c) for c in ("8bit", "sparse", "1bit")),
             images["img64"], enc_src["bench_rgba512"][::-1].copy()]
    want = [yaik_tpu_torch.encode_image(im, bank3d, device="cuda")
            for im in mixed]
    for name in ENCODE_KERNELS:
        getattr(kernels, name).launches = 0
    got = ebatch.encode_corpus(mixed, bank3d, batch_size=4, device="cuda")
    corpus_launches = {name: getattr(kernels, name).launches
                       for name in ENCODE_KERNELS}
    print(f"encode_corpus of {len(mixed)} RGB and RGBA images (512², 256², "
          f"64²): launches {corpus_launches}; each stream "
          f"{'equal to' if got == want else 'DIFFERS from'} encode_image's")
    if (got != want or corpus_launches["score48_mode"] < 6 * 4
            or 6 * corpus_launches["grad_score"]
            != corpus_launches["score48_mode"]):
        raise AssertionError("the mixed encode_corpus is wrong")
    for name, k in corpus_launches.items():
        launches[name] += k

    # the PLNT plane on the card against its CPU twin: every PLNT chunk of
    # the committed PLNT streams and of img512's stream with PLNT
    n_plnt = 0
    plnt_streams = {n: (FIX / f"{n}.yaik").read_bytes()
                    for n in ("img64.plnt", "corr2d128.plnt")}
    plnt_streams["img512 plnt"] = on_card["img512 plnt"]
    for label, stream in plnt_streams.items():
        for tag, _, body in iter_chunks(stream):
            if tag != b"PLNT":
                continue
            hdr = PlaneTile.unpack(body)
            luts, codes, vmask, nty, ntx = pack.plnt_args(
                hdr, body[PlaneTile.size():])
            planes2 = [engine.decode_plnt_plane(
                *(torch.from_numpy(a).to(d) for a in (luts, codes, vmask)),
                nty, ntx).cpu() for d in (dev, "cpu")]
            if not torch.equal(*planes2):
                raise AssertionError(f"PLNT plane of {label} differs")
            n_plnt += 1
    print(f"decode_plnt_plane: {n_plnt} PLNT planes on the card equal to "
          "their CPU twins")

    lap("3f")
    # -- phase 3f: LUT-bank mining through the user's entry points, the
    # coverage matrices on the card (counts from 0 before, read after);
    # the files against the CPU run's ------------------------------------
    import shutil
    mine_dir = ROOT / "build" / "chip_smoke_mining"
    shutil.rmtree(mine_dir, ignore_errors=True)
    mine3 = [images["img512"], base512["img512b"]]
    mine2 = [enc_src["corr2d128"], images["img128"]]
    for name in MINE_KERNELS + ("grad_score",):
        getattr(kernels, name).launches = 0
    t = time.perf_counter()
    res = {"cuda": (mining.mine_bank(mine3, mine_dir / "cuda", device="cuda"),
                    mining.mine_bank2d(mine2, mine_dir / "cuda2d",
                                       device="cuda"))}
    mine_s = time.perf_counter() - t
    launches.update({name: getattr(kernels, name).launches
                     for name in MINE_KERNELS})
    mine_grad = kernels.grad_score.launches
    launches["grad_score"] += mine_grad
    print(f"launches in mine_bank (img512, img512b) and mine_bank2d "
          f"(corr2d128, img128) on the card ({mine_s:.2f} s): "
          f"{ {n: launches[n] for n in MINE_KERNELS} }, grad_score "
          f"{mine_grad} (one per image mine_bank captures)")
    # the operands mine_bank2d handed covers2d (its clouds and every
    # step-th one as a candidate), against phase 2e's seeded mix
    clouds2 = [c for im in mine2 for c in mining.capture_clouds_2d(im)]
    cands2 = clouds2[::max(1, len(clouds2) // 256)]
    print("covers2d operands of mine_bank2d's captures (%d candidates, %d "
          "clouds): live-point share %.4f, counted-pixel share %.4f" % (
              len(cands2), len(clouds2), *torch_covers.shares(
                  mining._padded(cands2)[1], mining._padded(clouds2)[1])))
    if any(launches[n] != 1 for n in MINE_KERNELS) or mine_grad != 2:
        raise AssertionError("mining does not launch covers and covers2d "
                             "once per evaluation and grad_score once per "
                             "3D capture")
    t = time.perf_counter()
    res["cpu"] = (mining.mine_bank(mine3, mine_dir / "cpu", device="cpu"),
                  mining.mine_bank2d(mine2, mine_dir / "cpu2d", device="cpu"))

    def files(d):
        return {f.name: f.read_bytes() for f in sorted(d.iterdir())}
    same = res["cuda"] == res["cpu"] and all(
        files(mine_dir / f"cuda{s}") == files(mine_dir / f"cpu{s}")
        for s in ("", "2d"))
    print(f"mining: (tables, clouds) {res['cuda']}, files "
          f"{'equal to' if same else 'DIFFER from'} the CPU run's "
          f"({time.perf_counter() - t:.2f} s on the CPU)")
    if not same:
        raise AssertionError("mining on the card differs from the CPU run")
    mined_files = files(mine_dir / "cuda")          # phase 3g's reference
    shutil.rmtree(mine_dir, ignore_errors=True)

    lap("3g")
    # phase 3h's host encode of img512 (encode_image(engine="host"), numpy
    # scoring that holds the GIL most of its time) runs on a thread beside
    # phase 3g, whose main thread mostly waits on its subprocesses
    def host_encode(rgb: np.ndarray) -> tuple:
        t = time.perf_counter()
        return (yaik_tpu_torch.encode_image(rgb, bank3d, engine="host"),
                time.perf_counter() - t)
    host_pool = ThreadPoolExecutor(1)
    host_job = host_pool.submit(host_encode, images["img512"])

    # -- phase 3g: the command line, `python -m yaik_tpu_torch`, on the card
    # in subprocesses from the checkout's root; each stream, image and file
    # against its in-process twin, golden or digest, and the 4K traces
    # holding the CUDA kernels of the encode and the decode -------------
    from yaik_tpu_torch.utils import stats as statsmod
    from yaik_tpu_torch.utils.profiler import kernel_events
    torch.cuda.empty_cache()         # the subprocesses need the card's memory
    cli_dir = ROOT / "build" / "chip_smoke_cli"
    shutil.rmtree(cli_dir, ignore_errors=True)
    cli_dir.mkdir(parents=True)
    pngs = {"img512": FIX / "img512.png"}
    for n, img in (("sheet2048", enc_src["sheet2048"]),
                   ("bench_4k", images["bench_4k"])):
        pngs[n] = cli_dir / f"{n}.png"
        Image.fromarray(img).save(pngs[n], compress_level=1)
    lut2d = ["--lut2d", FIX / "LutFile2D.lut"]
    fused_cli = ["--t3-d1", "--grad-final"]

    def cli(label: str, *argv) -> tuple:
        """python -m yaik_tpu_torch <argv> on the card: (label, the
        finished process, its wall s)."""
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "yaik_tpu_torch",
                            *map(str, argv)], cwd=ROOT, capture_output=True,
                           text=True, timeout=600)
        return label, r, time.perf_counter() - t

    def shown(label: str, r, wall: float, how: str) -> str:
        """Print a command's wall and output; raise if it failed."""
        print(f"cli {label}: exit {r.returncode}, wall {wall:.3f} s ({how}) "
              f"[{card}]")
        for line in r.stdout.splitlines():
            print(f"  | {line}")
        if r.returncode:
            print(r.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"python -m yaik_tpu_torch {label} failed")
        return r.stdout

    # every process spends seconds importing torch on the card's machine,
    # so the commands only the checks need run together, one per host core;
    # those whose walls PERF.md reads run alone after them: `lut` (host
    # work only: the process's floor), the 4K encode and decode, and
    # mine-report
    together = [
        ("encode img512", "encode", pngs["img512"], cli_dir / "img512.yaik",
         "--profile", "--stats"),
        ("encode sheet2048", "encode", pngs["sheet2048"],
         cli_dir / "sheet2048.yaik", "--profile", "--stats"),
        ("encode bench_4k --trace", "encode", pngs["bench_4k"],
         cli_dir / "bench_4k_traced.yaik", "--trace",
         cli_dir / "trace_encode"),
        ("decode img512", "decode", FIX / "img512.yaik",
         cli_dir / "img512.png", "--profile"),
        ("decode bench_2d512", "decode", FIX / "bench_2d512.yaik",
         cli_dir / "bench_2d512.png", *lut2d, "--profile"),
        ("decode bench_rgba512", "decode", FIX / "bench_rgba512.yaik",
         cli_dir / "bench_rgba512.png", "--profile"),
        ("decode bench_4k fused", "decode", FIX / "bench_4k.yaik",
         cli_dir / "bench_4k_fused.png", *fused_cli, "--profile"),
        ("decode bench_4k --trace", "decode", FIX / "bench_4k.yaik",
         cli_dir / "bench_4k_traced.png", "--trace",
         cli_dir / "trace_decode"),
        ("stats bench_4k", "stats", FIX / "bench_4k.yaik")]
    alone = [("lut Bank3D", "lut", FIX / "Bank3D", cli_dir / "Bank3D.lut"),
             ("encode bench_4k", "encode", pngs["bench_4k"],
              cli_dir / "bench_4k.yaik", "--profile", "--stats"),
             ("decode bench_4k", "decode", FIX / "bench_4k.yaik",
              cli_dir / "bench_4k_split.png", "--profile"),
             ("mine-report img512 img512b", "mine-report",
              cli_dir / "mined", FIX / "img512.png", FIX / "img512b.png",
              "--report", cli_dir / "report.json")]
    out = {}
    t = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        for label, r, wall in pool.map(lambda a: cli(*a), together):
            out[label] = shown(label, r, wall, f"{len(together)} commands "
                               f"on {os.cpu_count()} workers")
    print(f"cli: the {len(together)} commands together took "
          f"{time.perf_counter() - t:.3f} s [{card}]")
    for a in alone:
        label, r, wall = cli(*a)
        out[label] = shown(label, r, wall, "alone")

    # every stream equals encode_image's on the card in this run
    for n, twin in (("img512", encoded["img512"]),
                    ("sheet2048", on_card["sheet2048"]),
                    ("bench_4k", encoded["bench_4k"]),
                    ("bench_4k_traced", encoded["bench_4k"])):
        got = (cli_dir / f"{n}.yaik").read_bytes()
        print(f"cli encode {n}: {len(got)} bytes, "
              f"{'equal to' if got == twin else 'DIFFERS from'} "
              "encode_image(device=\"cuda\")'s")
        if got != twin:
            raise AssertionError(f"the command line's encode of {n} differs")
    for png, name in (("img512", "img512"), ("bench_2d512", "bench_2d512"),
                      ("bench_rgba512", "bench_rgba512"),
                      ("bench_4k_split", "bench_4k"),
                      ("bench_4k_fused", "bench_4k"),
                      ("bench_4k_traced", "bench_4k")):
        hold(f"{name} by the command line ({png}.png)",
             np.asarray(Image.open(cli_dir / f"{png}.png")), name)
    want = statsmod.analyze(streams["bench_4k"]).summary() + "\n"
    lut_ok = ((cli_dir / "Bank3D.lut").read_bytes()
              == bankmod.write_lut_file(bank3d)
              == (FIX / "LutFile.lut").read_bytes())
    stats_ok = out["stats bench_4k"] == want
    print(f"cli stats bench_4k: {'equal to' if stats_ok else 'DIFFERS from'}"
          f" stats.analyze's summary; cli lut: "
          f"{'equal to' if lut_ok else 'DIFFERS from'} write_lut_file(Bank3D)"
          " and LutFile.lut")
    if not (stats_ok and lut_ok):
        raise AssertionError("the command line's stats or lut differs")

    # the traces: CUDA kernel events of the kernels each path launches
    # (kernel symbols as the profiler names them), as many as the
    # in-process counts of phase 3 and 3b: 6 per encode, 1 per decode
    symbols = {"grad_score": "grad_score_kernel(",
               "score48_mode": "score48_kernel<true>",
               "values48": "values48_kernel(", "grad_plane":
               "grad_plane_kernel<false>", "t3_merged": "merged_kernel<0>"}
    for trace_dir, label, want_k in (
            ("trace_encode", "encode bench_4k --trace",
             {"grad_score": 1, "score48_mode": 6, "values48": 6}),
            ("trace_decode", "decode bench_4k --trace",
             {"grad_plane": 1, "t3_merged": 1})):
        trace = json.loads((cli_dir / trace_dir / "trace.json").read_text())
        kev = kernel_events(trace)
        busy = sum(e["dur"] for e in kev) / 1e3
        span = (max(e["ts"] + e["dur"] for e in kev)
                - min(e["ts"] for e in kev)) / 1e3
        got_k = {k: sum(symbols[k] in e["name"] for e in kev) for k in want_k}
        print(f"trace {label}: {len(trace['traceEvents'])} events, "
              f"{len(kev)} CUDA kernel events summing {busy:.3f} ms over a "
              f"{span:.3f} ms span from the first kernel to the last; "
              f"kernels {got_k} [{card}]")
        if got_k != want_k:
            raise AssertionError(f"the trace of {label} holds {got_k} of "
                                 f"the kernels, not {want_k}")

    # mine-report: phase 3f's mined files, and bpp and PSNR of an
    # in-process encode and decode of the corpus with each bank
    same = files(cli_dir / "mined") == mined_files
    print(f"cli mine-report: mined files "
          f"{'equal to' if same else 'DIFFER from'} phase 3f's "
          "mine_bank(device=\"cuda\")")
    if not same:
        raise AssertionError("mine-report's mined files differ")
    report = json.loads((cli_dir / "report.json").read_text())
    for name, b in (("baseline", bank3d),
                    ("mined", bankmod.load_bank(str(cli_dir / "mined")))):
        blut = yaik_tpu_torch.assign_lut(bankmod.write_lut_file(b))
        bits = px = 0
        mse_sum = 0.0
        for img in mine3:
            enc = yaik_tpu_torch.encode_image(img, b, device="cuda")
            dec = yaik_tpu_torch.decode_image(enc, blut, device="cuda")
            bits += len(enc) * 8
            px += img.shape[0] * img.shape[1]
            mse_sum += float(((img.astype(np.float64)
                               - dec.astype(np.float64)) ** 2).mean())
        want_r = {"bpp": round(bits / px, 4), "psnr_db": round(float(
            10 * np.log10(255 ** 2 / (mse_sum / len(mine3)))), 3)}
        got_r = {k: report["banks"][name][k] for k in want_r}
        print(f"cli mine-report {name} bank: {got_r}, "
              f"{'equal to' if got_r == want_r else 'DIFFERS from'} the "
              f"in-process encode_image + decode_image {want_r}")
        if got_r != want_r:
            raise AssertionError(f"mine-report's {name} bpp or PSNR differs")
    shutil.rmtree(cli_dir, ignore_errors=True)

    lap("3h")
    # -- phase 3h: the host engines and the C library against the card, in
    # this process: every host decode (the numpy reference decoder) and
    # every C-library decode against the card's split and fused pixels, the
    # host encode's bytes (phase 3g's thread) against encode_image on the
    # card, the host miner's files against phase 3f's, and the command
    # line's --engine host against the card's outputs; with their walls --
    from yaik_tpu_torch.native import capi
    host_dir = ROOT / "build" / "chip_smoke_host"
    shutil.rmtree(host_dir, ignore_errors=True)
    host_dir.mkdir(parents=True)
    # the command line's host engines, in subprocesses beside this phase
    host_cli = {
        "decode": (["decode", FIX / "img512.yaik", host_dir / "img512.png",
                    "--engine", "host"], host_dir / "img512.png"),
        "encode": (["encode", FIX / "img512.png", host_dir / "img512.yaik",
                    "--engine", "host", "--profile"],
                   host_dir / "img512.yaik")}
    procs = {k: (time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "yaik_tpu_torch", *map(str, argv)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for k, (argv, _) in host_cli.items()}

    def stop_procs() -> None:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    atexit.register(stop_procs)         # also when a check below raises
    cores = os.cpu_count()

    def wall(fn, n: int) -> float:
        """The least wall seconds of `n` calls of fn."""
        best = float("inf")
        for _ in range(n):
            t = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t)
        return best

    t = time.perf_counter()
    clib_path = capi.build()
    clib_s = time.perf_counter() - t
    clib = capi.CLibrary()
    clib.assign_lut((FIX / "LutFile.lut").read_bytes())
    clib.assign_lut((FIX / "LutFile2D.lut").read_bytes())
    print(f"C library: {clib_path.name} built and loaded in {clib_s:.2f} s "
          "(g++, linking libzstd.so.1)")
    host_streams = {n: streams[n] for n in ("bench_4k", "img512", "img512b")}
    host_streams.update({n: fam[n] for n in (
        "bench_2d512", "bench_rgba512", "bench_ucol512", "gradpair192.gp",
        "crafted_3layer")})
    host_px, host_s = {}, {}
    for n, s in host_streams.items():
        t = time.perf_counter()
        host = yaik_tpu_torch.decode_image(s, bank, engine="host")
        host_s[n] = time.perf_counter() - t
        host_px[n] = host
        split = yaik_tpu_torch.decode_image(s, bank, device="cuda")
        fused = yaik_tpu_torch.decode_image(s, bank, device="cuda",
                                            t3_d1=True, grad_final=True)
        native_px = clib.decode(s)
        ok = {"split": np.array_equal(host, split),
              "fused": np.array_equal(host, fused),
              "C library": np.array_equal(native_px, split)}
        print(f"host decode {n} {'x'.join(map(str, host.shape))} "
              f"({host_s[n]:.2f} s): " + ", ".join(
                  f"{'equal to' if v else 'DIFFERS from'} the card's {k}"
                  if k != "C library" else
                  f"the C library's {'equal to' if v else 'DIFFERS from'} "
                  "the card's" for k, v in ok.items()))
        if not all(ok.values()):
            raise AssertionError(f"host or C-library decode of {n} differs "
                                 "from the card's")
    for n in ("bench_4k", "img512"):
        s = host_streams[n]
        w_host = host_s[n] if n == "bench_4k" else wall(
            lambda: yaik_tpu_torch.decode_image(s, bank, engine="host"), 3)
        w_c = wall(lambda: clib.decode(s), 3)
        w_split = wall(lambda: yaik_tpu_torch.decode_image(
            s, bank, device="cuda"), 3)
        w_fused = wall(lambda: yaik_tpu_torch.decode_image(
            s, bank, device="cuda", t3_d1=True, grad_final=True), 3)
        print(f"time decode {n} walls: host engine {w_host * 1e3:.2f} ms, "
              f"C library {w_c * 1e3:.2f} ms (both on the card's host, "
              f"{cores} cores, one thread), decode_image on the card split "
              f"{w_split * 1e3:.2f} ms, fused {w_fused * 1e3:.2f} ms "
              f"[{card}]")
    clib.close()

    # the host miner against phase 3f's files from the card
    t = time.perf_counter()
    mined = mining.mine_bank(mine3, host_dir / "mined", engine="host")
    same = mined == res["cuda"][0] and \
        files(host_dir / "mined") == mined_files
    print(f"host miner: mine_bank(engine=\"host\") of img512, img512b "
          f"{mined} in {time.perf_counter() - t:.2f} s, files "
          f"{'equal to' if same else 'DIFFER from'} phase 3f's on the card")
    if not same:
        raise AssertionError("the host miner's files differ from the card's")

    # the host encode (phase 3g's thread) against the card's bytes
    host_stream, host_enc_s = host_job.result()
    host_pool.shutdown()
    same = host_stream == encoded["img512"]
    print(f"host encode img512: {len(host_stream)} bytes, "
          f"{'equal to' if same else 'DIFFERS from'} encode_image(device="
          f"\"cuda\")'s of phase 3b")
    if not same:
        raise AssertionError("the host encode of img512 differs from the "
                             "card's")
    w_card = wall(lambda: yaik_tpu_torch.encode_image(
        images["img512"], bank3d, device="cuda"), 3)
    print(f"time encode img512 walls: host engine {host_enc_s:.2f} s (on a "
          f"thread beside phase 3g, the LUT maps built in it; the card's "
          f"host, {cores} cores), encode_image on the card {w_card:.3f} s "
          f"[{card}]")

    # load_bank on the device path builds no nearest-point map; the host
    # scorer's maps are built at its first read of them
    bank_dir = str(FIX / "Bank3D")
    w_load = wall(lambda: bankmod.load_bank.__wrapped__(bank_dir), 3)
    fresh = bankmod.load_bank.__wrapped__(bank_dir)
    w_maps = wall(lambda: [bankmod.nearest_maps(p) for p in fresh.points], 1)
    print(f"time load_bank(Bank3D) on the device path {w_load * 1e3:.2f} ms "
          f"({fresh.count} LUTs, maps unbuilt: "
          f"{all(c.maps is None for c in fresh.ctxs)}); the host scorer's "
          f"maps for them {w_maps * 1e3:.2f} ms at first use (the card's "
          f"host)")

    # the command line's --engine host against the card's outputs
    for k, (t, proc) in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        label = f"{k} img512 --engine host"
        shown(label, SimpleNamespace(returncode=proc.returncode,
                                     stdout=stdout, stderr=stderr),
              time.perf_counter() - t, "beside phase 3h")
    got = np.asarray(Image.open(host_cli["decode"][1]))
    same = (np.array_equal(got, host_px["img512"])
            and host_cli["encode"][1].read_bytes() == encoded["img512"])
    print(f"cli --engine host: decode img512 pixels and encode img512 bytes "
          f"{'equal to' if same else 'DIFFER from'} the card's")
    if not same:
        raise AssertionError("the command line's host engines differ")
    shutil.rmtree(host_dir, ignore_errors=True)

    lap("3i")
    # -- phase 3i: the emission's zstd pool and `entry()`. The 4K
    # encode_image with its zstd batch run on the calling thread and on the
    # pool, in the order serial, pool, pool, serial in this process (counts
    # from 0 before each, read after), each stream equal to phase 3b's; the
    # encode:zstd-flush stage, the batch's stream count and its largest
    # stream's compress time (the flush's floor), the wall and the RSS; the
    # 16-image corpus of phase 3d on 8 emission threads; entry()'s decode
    # of img128 on the card -----------------------------------------------
    import resource

    from yaik_tpu_torch import entry as entrymod
    from yaik_tpu_torch.encoder import context as ectx
    from yaik_tpu_torch.utils import profiler

    def rss_mb() -> str:
        """The process's resident memory now and at its peak, MB."""
        now = int(pathlib.Path("/proc/self/statm").read_text().split()[1])
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return (f"RSS {now * os.sysconf('SC_PAGE_SIZE') / 2**20:.0f} MB, "
                f"peak {peak / 1024:.0f} MB")

    def stage_ms(prof, name: str) -> float:
        """A stage's total ms, wherever it sits in the profile's tree."""
        todo, ms = [prof.root], 0.0
        while todo:
            node = todo.pop()
            ms += node.total * 1e3 if node.name == name else 0.0
            todo.extend(node.children.values())
        return ms

    flushed = []
    run_batch = ectx._ZstdBatch.run
    pool_n = ectx._cores()
    for workers in (0, None, None, 0):
        def kept_run(zb, workers=workers):     # keeps the 4K batch
            flushed.append(zb)
            return run_batch(zb, workers)
        ectx._ZstdBatch.run = kept_run
        flushed.clear()
        for name in ENCODE_KERNELS:
            getattr(kernels, name).launches = 0
        try:
            with profiler.enable() as prof:
                t = time.perf_counter()
                st = yaik_tpu_torch.encode_image(img4k, bank3d, device="cuda")
                wall_s = time.perf_counter() - t
        finally:
            ectx._ZstdBatch.run = run_batch
        got = {n: getattr(kernels, n).launches for n in ENCODE_KERNELS}
        if got != {"grad_score": 1, "score48": 0, "score48_mode": 6,
                   "values48": 6}:
            raise AssertionError(f"4K encode launches {got}")
        for name, k in got.items():
            launches[name] += k
        how = ("on the calling thread" if workers == 0
               else f"on the pool ({pool_n} threads)")
        print(f"time encode_image bench_4k, zstd {how}: encode:zstd-flush "
              f"{stage_ms(prof, 'encode:zstd-flush'):.2f} ms, "
              f"{len(flushed[0].jobs)} streams, wall {wall_s * 1e3:.2f} ms, "
              f"{rss_mb()}; bytes "
              f"{'equal to' if st == stream4k else 'DIFFER from'} phase 3b's;"
              f" launches {got} [{card}]")
        if st != stream4k:
            raise AssertionError(f"the 4K stream with zstd {how} differs")
    jobs = flushed[0].jobs
    each = []
    for job in jobs:
        t = time.perf_counter()
        ectx._compress_job(job)
        each.append(time.perf_counter() - t)
    big = int(np.argmax(each))
    print(f"time the 4K batch's {len(jobs)} streams one by one: sum "
          f"{sum(each) * 1e3:.2f} ms, largest {each[big] * 1e3:.2f} ms "
          f"(stream {big}, {len(jobs[big][0])} bytes in; the flush's floor), "
          f"sizes in {sorted(len(j[0]) for j in jobs)[::-1][:6]} ... bytes "
          f"[{card}]")

    for name in ENCODE_KERNELS:
        getattr(kernels, name).launches = 0
    t = time.perf_counter()
    got = ebatch.encode_corpus(corpus_imgs, bank3d, batch_size=8,
                               device="cuda", emit_workers=8)
    wall_s = time.perf_counter() - t
    corpus_launches = {n: getattr(kernels, n).launches for n in ENCODE_KERNELS}
    n_disp = corpus_launches["score48_mode"] // 6
    same = got == corpus3d
    print(f"time encode_corpus {len(ckeys)} images, {enc_mpix:.2f} MPix, 8 "
          f"emission threads on the zstd pool: {wall_s:.3f} s, "
          f"{enc_mpix / wall_s:.2f} MPix/s, {rss_mb()}; launches "
          f"{corpus_launches}; streams {'equal to' if same else 'DIFFER from'}"
          f" phase 3d's [{card}]")
    if (not same or n_disp < 1 or corpus_launches != {
            "grad_score": n_disp, "score48": 0, "score48_mode": 6 * n_disp,
            "values48": 6 * n_disp}):
        raise AssertionError("encode_corpus with emission threads is wrong")
    for name, k in corpus_launches.items():
        launches[name] += k

    fn, eargs = entrymod.entry(FIX / "img128.yaik", FIX / "LutFile.lut")
    reset()
    px = fn(*eargs)
    torch.cuda.synchronize()
    got, want = counts(), expected(std_args["img128"])
    print(f"entry(): fn(*example_args) on {px.device}, launches {got}")
    if got != want:
        raise AssertionError(f"entry() launches {got}, img128's split decode "
                             f"calls for {want}")
    for name, k in got.items():
        launches[name] += k
    hold("img128 through entry()", px.cpu().numpy(), "img128")
    ms = cuda_ms(lambda: fn(*eargs), 10)       # 64 kernels a call
    b2b = cuda_ms(lambda: fn(*eargs), 20, queued=False)
    print(f"time entry() fn img128: device {ms:.4f} ms, back-to-back with "
          f"host dispatch {b2b:.4f} ms [{card}]")

    lap("3j")
    # -- phase 3j: the split over a list of devices (`devices=`). The port's
    # dryrun_multichip (the JAX package's seven axes) over [cuda:0] * 4,
    # and over every card where there are several (counts from 0 before
    # each, read after); each kernel an axis reaches launches at least
    # once a slice on each listed card. On one card the four slices run one
    # after another: this shows the split and the join, not scaling. Then
    # the walls of phase 3c's and 3d's corpora split over [cuda:0] * 2,
    # dispatched from this thread and from a thread a slice, against
    # device="cuda:0" (least of 3, in turns) -------------------------------
    split_kernels = DECODE_KERNELS + ENCODE_KERNELS
    runs = [("[cuda:0] * 4", [dev] * 4)]
    if torch.cuda.device_count() >= 2:
        runs.append(("data_devices()", batch.data_devices()))
    else:
        print("dryrun_multichip over distinct cards: not run, "
              f"{torch.cuda.device_count()} card present")
    for label, devs in runs:
        for name in split_kernels:
            getattr(kernels, name).launches = 0
            getattr(kernels, name).per_device.clear()
        t = time.perf_counter()
        per_axis = entrymod.dryrun_multichip(len(devs), devices=devs)
        wall_s = time.perf_counter() - t
        for name in split_kernels:
            launches[name] += getattr(kernels, name).launches
        slices = {str(d): devs.count(d) for d in devs}
        for axis, per_dev in per_axis.items():
            print(f"dryrun_multichip {label} {axis}: launches per device "
                  f"{per_dev}")
            reached = {k for ks in per_dev.values() for k in ks}
            short = [(d, k) for d, m in slices.items() for k in reached
                     if per_dev.get(d, {}).get(k, 0) < m]
            if not reached or short or set(per_dev) - set(slices):
                raise AssertionError(f"dryrun_multichip {label} {axis}: "
                                     f"launches {per_dev} miss a slice of "
                                     f"{slices}: {short}")
        n = len(devs)
        want1 = {k: v * n for k, v in expected(std_args["img64"]).items()
                 if v}
        got1 = {k: sum(c.get(k, 0) for c in per_axis["DP"].values())
                for k in want1}
        got6 = {k: sum(c.get(k, 0) for c in per_axis[
            "encode-scoring DP"].values()) for k in ENCODE_KERNELS}
        if got1 != want1 or got6 != {"grad_score": n, "score48": 0,
                                     "score48_mode": 6 * n,
                                     "values48": 6 * n}:
            raise AssertionError(f"dryrun_multichip {label}: DP launches "
                                 f"{got1} (want {want1}), encode-scoring "
                                 f"{got6}")
        print(f"dryrun_multichip {label}: the seven axes in {wall_s:.2f} s; "
              f"DP {got1}, encode-scoring {got6}: one launch set a slice "
              f"[{card}]")

    def thread_a_slice(fn, jobs: list) -> list:
        """The alternative to `batch.over_slices`: each slice dispatched
        from a thread of its own."""
        with ThreadPoolExecutor(len(jobs)) as pool:
            return list(pool.map(lambda job: fn(*job), jobs))

    corpus_streams = [src[n] for n in corpus]
    one_thread = batch.over_slices
    split_s: dict = {}
    for _ in range(3):
        for how in ("device=cuda:0", "devices=[cuda:0] * 2",
                    "devices=[cuda:0] * 2, a thread a slice"):
            kw = ({"device": dev} if how.startswith("device=")
                  else {"devices": [dev] * 2})
            if how.endswith("slice"):
                batch.over_slices = thread_a_slice
            try:
                t = time.perf_counter()
                res = batch.decode_corpus(corpus_streams, bank, batch_size=8,
                                          **kw)
                t_dec = time.perf_counter() - t
                t = time.perf_counter()
                enc = ebatch.encode_corpus(corpus_imgs, bank3d,
                                           batch_size=8, **kw)
                t_enc = time.perf_counter() - t
            finally:
                batch.over_slices = one_thread
            if not all(np.array_equal(r, ref[n]) for r, n in
                       zip(res, corpus)) or enc != corpus3d:
                raise AssertionError(f"the corpora with {how} differ")
            for key, s in (("decode", t_dec), ("encode", t_enc)):
                split_s.setdefault((key, how), []).append(s)
    for (key, how), walls in split_s.items():
        mpix = corpus_mpix if key == "decode" else enc_mpix
        print(f"time {key}_corpus {mpix:.2f} MPix, batch_size 8, {how}: "
              f"least of 3 {min(walls):.3f} s ({mpix / min(walls):.2f} "
              f"MPix/s), walls {' '.join(f'{w:.3f}' for w in walls)} s; "
              f"pixels / bytes equal to phase 3c's / 3d's [{card}]")

    lap("3k")
    # -- phase 3k: edge shapes, the image sides no fixture has
    # (tests/torch_streams.py's EDGE_CROPS): 16 px wide, where the 16-wide
    # 3D pass has one tile column, and w % 16 == 8 or h % 16 == 8, where
    # the last column or row of 16-px tiles is half a tile. One run of
    # encode_image and decode_image (split and fused) over the crops on the
    # card, counts from 0 before it, read after; then each stream against
    # the CPU path's, the emission with the host library off, a second call
    # and encode_batch of two copies, each decode against decode_batch, the
    # host decoder, the C library and tests/fixtures/edge_digests.json (the
    # JAX package's reference decode of its Python-emission stream); and
    # score48_mode and values48 against their plain versions on the 16-wide
    # crops' dense operands, all six passes ----------------------------------
    from torch_streams import EDGE_CROPS, edge_crop
    from yaik_tpu_torch.native import capi
    edge_want = json.loads((FIX / "edge_digests.json").read_text())
    edge_imgs = {n: edge_crop(n) for n in EDGE_CROPS}
    edge_kernels = DECODE_KERNELS + ENCODE_KERNELS
    for name in edge_kernels:
        getattr(kernels, name).launches = 0
    t = time.perf_counter()
    edge_enc = {n: yaik_tpu_torch.encode_image(im, bank3d, device="cuda")
                for n, im in edge_imgs.items()}
    edge_px = {(n, form): yaik_tpu_torch.decode_image(s, bank, device="cuda",
                                                      **flags)
               for n, s in edge_enc.items()
               for form, flags in (("split", {}), ("fused", fused_flags))}
    edge_s = time.perf_counter() - t
    edge_launches = {name: getattr(kernels, name).launches
                     for name in edge_kernels}
    edge_args = [pack.plan_to_args(planner.build_plan(
        s, bank.expanded, bank.expanded2d), lut, dtabs.lut2)
        for s in edge_enc.values()]
    n_edge = len(edge_imgs)
    want = {**total(edge_args), "grad_score": n_edge, "score48": 0,
            "score48_mode": 6 * n_edge, "values48": 6 * n_edge}
    for name, k in total(edge_args, **fused_flags).items():
        want[name] += k
    print(f"launches in the edge-shape run ({n_edge} encodes, "
          f"{2 * n_edge} decodes, {edge_s:.2f} s): {edge_launches}")
    if edge_launches != want:
        raise AssertionError(f"edge-shape launches {edge_launches}, the "
                             f"operands call for {want}")
    for name in ("grad_score", "score48_mode", "values48", "grad_plane",
                 "grad_plane_final", "t3_merged", "t3_merged_d1"):
        if edge_launches[name] == 0:
            raise AssertionError(f"{name} was not launched by the "
                                 "edge-shape run")
    for name, k in edge_launches.items():
        launches[name] += k
    clib = capi.CLibrary()
    clib.assign_lut((FIX / "LutFile.lut").read_bytes())
    clib.assign_lut((FIX / "LutFile2D.lut").read_bytes())
    host_lib = native.available
    for n, img in edge_imgs.items():
        stream = edge_enc[n]
        native.available = lambda: False
        try:
            no_native = yaik_tpu_torch.encode_image(img, bank3d,
                                                    device="cuda")
        finally:
            native.available = host_lib
        others = {
            "encode_image(device=\"cpu\")": [yaik_tpu_torch.encode_image(
                img, bank3d, device="cpu")],
            "the host library off": [no_native],
            "a second call": [yaik_tpu_torch.encode_image(img, bank3d,
                                                          device="cuda")],
            "encode_batch of two copies": ebatch.encode_batch(
                [img, img.copy()], bank3d, device="cuda")}
        bad = [k for k, v in others.items() if v != [stream] * len(v)]
        px = edge_px[n, "split"]
        decodes = {"fused": [edge_px[n, "fused"]],
                   "decode_batch of two copies": list(batch.decode_batch(
                       [stream, stream], bank, device="cuda")),
                   "the host decoder": [yaik_tpu_torch.decode_image(
                       stream, bank, engine="host")],
                   "the C library": [clib.decode(stream)]}
        bad += [k for k, v in decodes.items()
                if not all(np.array_equal(px, o) for o in v)]
        want_d = edge_want[n]
        if digest(px) != {"shape": want_d["shape"],
                          "sha256": want_d["sha256"]}:
            bad.append("the digest of the JAX package's reference decode")
        print(f"encode {n} {img.shape[0]}x{img.shape[1]}x{img.shape[2]}: "
              f"{len(stream)} bytes (the JAX package's {want_d['bytes']} "
              f"through its own zstd), PSNR {psnr(px, img):.2f} dB; "
              + ("bytes equal to " + ", ".join(others) + "; pixels equal "
                 "to the split decode's by " + ", ".join(decodes)
                 + " and the digest" if not bad
                 else "DIFFERS from " + ", ".join(bad)))
        if bad:
            raise AssertionError(f"edge shape {n} differs from {bad}")
    clib.close()
    # the 16-wide crops' dense operands: their 16x8 pass has one tile column
    for n in (n for n, (_, _, w) in EDGE_CROPS.items() if w == 16):
        planes = planes_of(edge_imgs[n][..., :3], dev)
        claims = torch.zeros(planes.shape, dtype=torch.bool, device=dev)
        scoring.gradient_all(planes, claims, 3)
        errs = {"score48_mode": 0, "values48": 0}
        for (sx, sy) in swizzle.TILE3D_PASS_ORDER:
            o = scoring.tile3d_operands(planes, claims, sx, sy)
            alive = ~o.mask
            mode = kernels.score48_mode(o.c, alive, tabs.qpts)
            errs["score48_mode"] = max(errs["score48_mode"], max_abs_err(
                mode, kernels.score48_mode_plain(o.c, alive, tabs.qpts)))
            v_args = (o.tiles, alive, o.a_c, o.b_c, mode, o.mn, o.mx - o.mn,
                      tabs.pts, tabs.factors)
            errs["values48"] = max(errs["values48"], *(
                max_abs_err(g, p) for g, p in zip(
                    kernels.values48(*v_args),
                    kernels.values48_plain(*v_args))))
            scoring.tile3d_pass(planes, claims, tabs, sx, sy)
        for name, e in errs.items():
            err[name] = max(err[name], e)
        print(f"kernels vs plain on {n}'s dense operands, six passes: "
              f"max_abs_err {errs}")
        if any(errs.values()):
            raise AssertionError(f"kernels differ from plain on {n}: {errs}")

    lap("4")
    # -- phase 4: timing ---------------------------------------------------
    kms = {}
    earlier_ms = {}   # the earlier design's ms, where one is kept
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

    # the batch path: the core's device time per image at B = 1, 4, 16, 64
    # (512^2, split and fused), each decode kernel batched against B
    # unbatched calls, the upload, the host's plan and pack per image, and
    # decode_batch's wall by stage
    bargs = {}
    for B in (1, 4, 16, 64):
        bplans = ([plans["img512"], plans["img512b"]] * B)[:B]
        bargs[B] = batch.batch_operands(bplans, dtabs)[0]
        d = engine.upload(bargs[B], dev)
        mpix = B * 512 * 512 / 1e6
        for label, flags in (("split", {}), ("fused", fused_flags),
                             ("fused", fused_flags), ("split", {})):
            ms = cuda_ms(lambda: engine.decode_core(d, dtabs, **flags), 10)
            b2b = cuda_ms(lambda: engine.decode_core(d, dtabs, **flags), 20,
                          queued=False)
            print(f"time decode_batch core B={B} 512x512 {label} form: "
                  f"device {ms:.4f} ms/batch, {ms / B:.5f} ms/image "
                  f"({mpix / ms * 1e3:.1f} MPix/s); back-to-back with host "
                  f"dispatch {b2b:.4f} ms/batch, {b2b / B:.5f} ms/image "
                  f"({mpix / b2b * 1e3:.1f} MPix/s) [{card}]")
    d = engine.upload(bargs[16], dev)
    d1p = engine.upload(pack.stack_args([pack.plan_to_args(
        p, lut, t3_form="passes") for p in
        ([plans["img512"], plans["img512b"]] * 8)]), dev)
    vc16 = kernels.t3_merged_d1(*d1_args(d))
    per_kernel = {"grad_plane": ((d.corners, d.code4), GRAD),
                  "grad_plane_final": ((d.corners, d.code4, vc16), GRAD),
                  "t3_merged": (t3_args(d), LAYERS),
                  "t3_merged_d1": (d1_args(d), D1),
                  "lut_pass": (pass_args(tab, d1p.t3_passes[-1], 512, 512),
                               PASS + (None,) * 6)}
    for name, (a, axes) in per_kernel.items():
        fn = getattr(kernels, name)
        ones = [tuple(x if ax is None else x.select(ax, b).contiguous()
                      for x, ax in zip(a, axes)) for b in range(16)]
        t1 = cuda_ms(lambda: [fn(*o) for o in ones], 20)
        tb = cuda_ms(lambda: fn(*a), 50)
        t2 = cuda_ms(lambda: [fn(*o) for o in ones], 20)
        tb2 = cuda_ms(lambda: fn(*a), 50)
        print(f"time {name} 512x512 x 16: batched {tb / 16:.5f} / "
              f"{tb2 / 16:.5f} ms/image, 16 unbatched launches "
              f"{t1 / 16:.5f} / {t2 / 16:.5f} ms/image (one, batch, one, "
              f"batch) [{card}]")
    n16 = sum(x.nbytes for x in _arrays(bargs[16]))
    row = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.upload(bargs[16], dev)
        torch.cuda.synchronize()
        row.append(f"{(time.perf_counter() - t) * 1e3:.3f} ms")
    print(f"time upload B=16 512x512 (engine.upload, pageable): "
          f"{n16 / 1e6:.2f} MB per batch; {', '.join(row)} [{card}]")
    # what a pinned upload of the same bytes would cost, in its two parts:
    # the host copy into pinned memory, and the copy to the card (from
    # pinned memory, and from pageable memory for comparison)
    pinned = torch.empty(n16, dtype=torch.uint8, pin_memory=True)
    pageable = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, n16, dtype=np.uint8))
    t = time.perf_counter()
    for _ in range(5):
        pinned.numpy()[:] = pageable.numpy()
    host_ms = (time.perf_counter() - t) / 5 * 1e3
    h2d = {k: cuda_ms(lambda: src.to(dev, non_blocking=True), 5,
                      queued=False)
           for k, src in (("pinned", pinned), ("pageable", pageable))}
    print(f"time upload parts, {n16 / 1e6:.2f} MB: host copy into pinned "
          f"memory {host_ms:.3f} ms ({n16 / host_ms / 1e6:.2f} GB/s); one "
          f"copy to the card from pinned {h2d['pinned']:.3f} ms "
          f"({n16 / h2d['pinned'] / 1e6:.2f} GB/s), from pageable "
          f"{h2d['pageable']:.3f} ms ({n16 / h2d['pageable'] / 1e6:.2f} "
          f"GB/s) [{card}]")
    del pinned, pageable
    names16 = ["img512", "img512b"] * 8
    t = time.perf_counter()
    p16 = [planner.build_plan(streams[n], bank.expanded) for n in names16]
    t_plan = time.perf_counter() - t
    t = time.perf_counter()
    a16 = [pack.plan_to_args(p, lut) for p in p16]
    t_pack = time.perf_counter() - t
    t = time.perf_counter()
    a16, _ = batch.batch_operands(p16, dtabs, a16)
    t_stack = time.perf_counter() - t
    t = time.perf_counter()
    d = engine.upload(a16, dev)              # as decode_batch uploads
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t
    t = time.perf_counter()
    out = engine.decode_core(d, dtabs)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t
    t = time.perf_counter()
    out.cpu().numpy()
    t_down = time.perf_counter() - t
    t = time.perf_counter()
    batch.decode_batch([streams[n] for n in names16], bank, device="cuda")
    t_wall = time.perf_counter() - t
    print(f"time decode_batch img512, img512b x 8 (B=16) by stage: plan "
          f"{t_plan * 1e3:.2f} ms ({t_plan / 16 * 1e3:.2f}/image), pack "
          f"{t_pack * 1e3:.2f} ms ({t_pack / 16 * 1e3:.2f}/image), stack "
          f"{t_stack * 1e3:.2f} ms, upload (pageable) {t_up * 1e3:.3f} ms, "
          f"decode_core {t_dec * 1e3:.3f} "
          f"ms, download {t_down * 1e3:.3f} ms; decode_batch wall "
          f"{t_wall * 1e3:.2f} ms, the upload {t_up / t_wall:.1%} of it "
          f"[{card}]")
    host = os.cpu_count()
    for workers, sec in corpus_s.items():
        print(f"time decode_corpus {len(corpus)} streams, {corpus_mpix:.2f} "
              f"MPix, {workers} planner threads of {host} host cores: "
              f"{sec:.3f} s, {corpus_mpix / sec:.1f} MPix/s, "
              f"{len(corpus) / sec:.1f} images/s [{card}]")

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

    def kernel_sum(fn) -> tuple:
        """One warm call of `fn` under torch.profiler: (the device time of
        its kernels in ms, their launches, rows (ms, count, name) by
        time). The call is bracketed by two `torch.cuda._sleep` kernels
        (`spin_kernel`, left out of the rows); a window that records
        neither is taken again, at most three times (on the H100 one window
        holding a single launch, right after a window of ~1,000, recorded
        no kernel). `fn` must take fresh operands each call."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(1000)
                fn()
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
            events = [ev for ev in prof.key_averages()
                      if ev.device_time_total > 0]
            if any("spin_kernel" in ev.key for ev in events):
                break
            print("  profile: the window recorded no marker kernel; again")
        else:
            raise AssertionError("torch.profiler recorded no marker kernel "
                                 "in three windows")
        rows = sorted(((ev.device_time_total / 1e3, ev.count, ev.key)
                       for ev in events if "spin_kernel" not in ev.key),
                      reverse=True)
        return (sum(r[0] for r in rows), sum(r[1] for r in rows), rows)

    for n in ("img512", "bench_4k"):
        img = images[n]
        planes = planes_of(img, dev)

        def score_on_device(plain_grad=False):
            claims = torch.zeros(planes.shape, dtype=torch.bool, device=dev)
            scoring.gradient_all(planes, claims, 3, plain=plain_grad)
            pipeline.tile3d_all(planes, claims, tabs)
        ms = cuda_ms(score_on_device, 1)     # ~370 launches a call
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
        # one warm scoring call by kernel, with the gradient stage as
        # grad_score and as its plain version (the per-pass torch ops that
        # ran there before it), in turns
        for i, plain_grad in enumerate((True, False, False, True)):
            busy, nl, rows = kernel_sum(lambda: score_on_device(plain_grad))
            b2b = cuda_ms(lambda: score_on_device(plain_grad), 3,
                          queued=False)
            how = ("the plain gradient stage" if plain_grad
                   else "grad_score")
            print(f"profile encode {n} scoring, {how}: device {busy:.3f} ms "
                  f"in {nl} kernel launches, back-to-back {b2b:.3f} ms "
                  f"[{card}]")
            if n == "bench_4k" and i < 2:
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
            # the plain versions (values48's ~5 s a call) on the 4x4 pass only
            row = (2, 2) == (sx, sy)
            p1 = (cuda_ms(plain, 1, queued=False, warm=False) if row
                  else float("nan"))
            k1 = cuda_ms(fn, 20)
            k2 = cuda_ms(fn, 20)
            p2 = (cuda_ms(plain, 1, queued=False, warm=False) if row
                  else float("nan"))
            extra = (f"; every tensor in full {full[0]:.4f} ms ({full[1]}), "
                     f"every pixel x E x 120 points {old[0]:.4f} ms "
                     f"({old[1]})" if name == "values48" else "")
            plain_ms = (f"plain {p1:.4f} / {p2:.4f} ms (plain, kernel, "
                        "kernel, plain)" if row else "plain not timed")
            print(f"time {name} {label}: kernel {k1:.4f} / {k2:.4f} ms, "
                  f"{plain_ms}; bound {b[name][0]:.4f} ms ({b[name][1]}), "
                  f"{b[name][0] / ((k1 + k2) / 2):.0%} of it{extra} [{card}]")
            if row:
                kms[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
                bounds[name] = b[name]

    # grad_score on the 4K image against its plain version and against the
    # kernel's earlier design (tests/grad_score_cta.cu, built alone: a CTA
    # per block, a thread a pixel), each call on zeroed claims of its own
    # (the main path's), in turns; and the bound of its work: the planes
    # read once, the claims read and written, the accepts written; 12 int32
    # operations per (pixel, channel, pass), per blend variant the
    # numerator's step, the add of the pixel's term, a min and a max
    # (grad_score.cu's header note)
    planes4k = planes_of(img4k, dev)
    earlier, earlier_ptxas = time_grad_score.alone_library(
        time_grad_score.EARLIER, "earlier_grad_score")
    for line in earlier_ptxas:
        print(f"  ptxas (the earlier grad_score design): {line}")

    def on_fresh_claims(fn, n):
        pool = iter([zeros_like(planes4k) for _ in range(n)])
        return lambda: fn(planes4k, next(pool), 3)

    def earlier_call(planes, claims, rf):
        return time_grad_score.alone_call(earlier, planes, claims, rf)
    c_e, c_p = zeros_like(planes4k), zeros_like(planes4k)
    if not (torch.equal(earlier_call(planes4k, c_e, 3),
                        kernels.grad_score_plain(planes4k, c_p, 3))
            and torch.equal(c_e, c_p)):
        raise AssertionError("the earlier grad_score design differs from "
                             "the plain version at 4K")
    del c_e, c_p
    p1 = cuda_ms(on_fresh_claims(kernels.grad_score_plain, 4), 3,
                 queued=False)
    e1 = cuda_ms(on_fresh_claims(earlier_call, 23), 20)
    k1 = cuda_ms(on_fresh_claims(kernels.grad_score, 23), 20)
    k2 = cuda_ms(on_fresh_claims(kernels.grad_score, 23), 20)
    e2 = cuda_ms(on_fresh_claims(earlier_call, 23), 20)
    p2 = cuda_ms(on_fresh_claims(kernels.grad_score_plain, 4), 3,
                 queued=False)
    earlier_ms["grad_score"] = (e1 + e2) / 2
    claims = zeros_like(planes4k)
    out = kernels.grad_score(planes4k, claims, 3)
    h4, w4 = img4k.shape[:2]
    px_passes = sum(((h4 >> sy) << sy) * ((w4 >> sx) << sx)
                    for (sx, sy) in swizzle.GRADIENT_PASS_ORDER)
    grad_ops = px_passes * time_grad_score.OPS_PER_PIXEL_PASS
    bounds["grad_score"] = bound([planes4k, claims], [claims, out],
                                 grad_ops, "i32")
    # the gradient stage as the encode path calls it launches grad_score and
    # nothing else: no per-pass torch op is left
    _, nl, rows = kernel_sum(on_fresh_claims(scoring.gradient_packed, 4))
    print(f"profile the 4K gradient stage (scoring.gradient_packed): {nl} "
          f"kernel launch(es): {[key[:60] for _, _, key in rows]} [{card}]")
    if nl != 1 or "grad_score_kernel" not in rows[0][2]:
        raise AssertionError("the gradient stage launches more than "
                             "grad_score")
    plain_dev, plain_n, _ = kernel_sum(on_fresh_claims(
        kernels.grad_score_plain, 4))
    kms["grad_score"] = ((k1 + k2) / 2, (p1 + p2) / 2)
    gb = bounds["grad_score"][0]
    print(f"time grad_score bench_4k 3840x2160: kernel {k1:.4f} / {k2:.4f} "
          f"ms, the earlier design {e1:.4f} / {e2:.4f} ms, plain {p1:.4f} / "
          f"{p2:.4f} ms back to back (plain, earlier, kernel, kernel, "
          f"earlier, plain; the plain version's kernels {plain_dev:.3f} ms "
          f"of device time in {plain_n} launches); bound {gb:.4f} ms "
          f"({bounds['grad_score'][1]}, {grad_ops:.4g} operations, "
          f"{nbytes(planes4k, claims, claims, out) / 1e6:.1f} MB), "
          f"{gb / kms['grad_score'][0]:.0%} of it (the earlier design "
          f"{gb / earlier_ms['grad_score']:.0%}); {int(out.sum())} of "
          f"{out.numel()} tiles accepted [{card}]")
    del planes4k, claims, out

    # the batch encode path (phase 3d's images): device scoring per 512^2
    # image at B = 1, 4, 16 (the gradient stage and the six compacted 3D
    # passes, no download), the cap's saving, the bytes each download
    # takes, the transients' peak, and encode_corpus end to end
    enc16 = [img_of[(("img512", "img512b")[i % 2], i)] if i < 10 else
             variant(base512[("img512", "img512b")[i % 2]], i)
             for i in range(16)]
    perms512 = pipeline.scan_perms(512, 512, dev)

    def score_batch(planes, caps, plain_grad=False):
        if plain_grad:          # the gradient stage's plain version
            claims = zeros_like(planes)
            kernels.grad_score_plain(planes, claims, cfg.reject_factor)
        else:
            _, claims = ebatch._score_gradients(planes, cfg)
        return pipeline._tile3d_all_compact(planes, claims, tabs, perms512,
                                            caps)
    for B in (1, 4, 16):
        planes = ebatch._upload(enc16[:B], dev)
        mpix = B * 512 * 512 / 1e6
        # the gradient stage as grad_score and as its plain version (the
        # per-pass torch ops that ran there before it), in turns
        for plain_grad in (True, False, False, True):
            how = ("the plain gradient stage" if plain_grad
                   else "grad_score")
            ms = cuda_ms(lambda: score_batch(planes, caps512, plain_grad), 1)
            b2b = cuda_ms(lambda: score_batch(planes, caps512, plain_grad),
                          3, queued=False)
            busy, nl, _ = kernel_sum(
                lambda: score_batch(planes, caps512, plain_grad))
            # past ~1,000 queued launches the host blocks behind the sleep,
            # so the profiler's kernel sum is the device time of a batch
            print(f"time encode scoring B={B} 512x512 (gradients + "
                  f"compacted 3D passes at the caps learned, blob on the "
                  f"card), {how}: device (kernel sum, profiler) "
                  f"{busy:.3f} ms/batch, {busy / B:.4f} ms/image "
                  f"({mpix / busy * 1e3:.1f} MPix/s) in {nl} launches; "
                  f"queued behind a sleep {ms:.3f} ms/batch "
                  f"({ms / B:.4f} ms/image); back-to-back {b2b:.3f} "
                  f"ms/batch, {b2b / B:.4f} ms/image "
                  f"({mpix / b2b * 1e3:.1f} MPix/s) [{card}]")
    # what the cap saves: the 4x4 pass's operand stage, and all six 3D
    # passes with their scoring, capped against dense (B = 16 512^2, and
    # the 4K image alone), on the claims the gradient stage leaves
    for label, imgs in (("B=16 512x512", enc16), ("B=1 3840x2160",
                                                  [img4k])):
        planes = ebatch._upload(imgs, dev)
        h, w = imgs[0].shape[:2]
        caps = ebatch._CAP_STATE.get((h, w, cfg.reject_factor),
                                     pipeline.pass_caps(w, h))
        perms = pipeline.scan_perms(w, h, dev)
        _, claims0 = ebatch._score_gradients(planes, cfg)
        ops_ms, all_ms = {}, {}
        for form in ("dense", "capped", "capped", "dense"):
            cap = None if form == "dense" else caps[-1][0]
            ops_ms.setdefault(form, []).append(cuda_ms(
                lambda: scoring.tile3d_operands_b(planes, claims0, 2, 2, cap),
                5))

            def passes():
                claims = claims0.clone()
                if form == "dense":
                    return pipeline._tile3d_all(planes, claims, tabs)
                return pipeline._tile3d_all_compact(planes, claims, tabs,
                                                    perms, caps)
            all_ms.setdefault(form, []).append(cuda_ms(passes, 1))
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        score = (score_batch if label.startswith("B=16") else
                 lambda p, c: pipeline._tile3d_all_compact(
                     p, ebatch._score_gradients(p, cfg)[1], tabs, perms, c))
        score(planes, caps)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        npx = len(imgs) * h * w
        print(f"time encode 3D stage {label}, caps {caps}: operands of "
              f"the 4x4 pass "
              f"dense {ops_ms['dense'][0]:.3f} / {ops_ms['dense'][1]:.3f} "
              f"ms, capped (C = {caps[-1][0]}) {ops_ms['capped'][0]:.3f} / "
              f"{ops_ms['capped'][1]:.3f} ms; six passes with scoring dense "
              f"{all_ms['dense'][0]:.3f} / {all_ms['dense'][1]:.3f} ms, "
              f"capped {all_ms['capped'][0]:.3f} / {all_ms['capped'][1]:.3f} "
              f"ms (dense, capped, capped, dense); peak transients of the "
              f"capped scoring {peak / 1e6:.1f} MB, {peak / npx:.1f} B/pixel "
              f"[{card}]")
        del planes, claims0
    # bytes downloaded per image: encode_image's dense dicts, the dense
    # packed rows (the banded path), and the compact blob
    for w, h in ((512, 512), (3840, 2160)):
        dense = packed = ebatch._grad_packed_len(w, h)
        for (sx, sy) in swizzle.TILE3D_PASS_ORDER:
            T, P = (h >> sy) * (w >> sx), 1 << (sx + sy)
            dense += T * (1 + 4 + 6 + 2 * P)  # accept, type, bbox, idx, mask
            packed += T * (P + 9)
        compact = {}
        for which, caps in (("default", pipeline.pass_caps(w, h)),
                            ("learned", ebatch._CAP_STATE.get(
                                (h, w, cfg.reject_factor)))):
            if caps is None:
                continue
            compact[which] = ebatch._grad_packed_len(w, h) + sum(
                -(-pipeline._scan_perm(sx, sy, w, h)[1].shape[0] // 8) + 8
                + dcap * ((1 << (sx + sy)) + 9)
                for (sx, sy), (_, dcap) in zip(swizzle.TILE3D_PASS_ORDER,
                                               caps))
        print(f"download per {w}x{h} image: encode_image's dense results "
              f"{dense / 1e6:.3f} MB, dense packed rows {packed / 1e6:.3f} "
              "MB, compact blob " + ", ".join(
                  f"at the {k} caps {v / 1e6:.3f} MB ({dense / v:.1f}x less "
                  "than dense)" for k, v in compact.items()))
    # encode_corpus end to end; the host's time split by wrapping the
    # batch module's dispatch, wait and emission
    spent = {}

    def timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t
        return run
    orig = (ebatch._dispatch_batch, ebatch._emit_from_unpacked,
            ebatch._InFlight.wait)
    ebatch._dispatch_batch = timed("dispatch", orig[0])
    ebatch._emit_from_unpacked = timed("emit", orig[1])
    ebatch._InFlight.wait = timed("wait", orig[2])
    host = os.cpu_count()
    try:
        for workers in (0, host, host, 0):
            spent.clear()
            t = time.perf_counter()
            got = ebatch.encode_corpus(corpus_imgs, bank3d, batch_size=8,
                                       device="cuda", emit_workers=workers)
            wall = time.perf_counter() - t
            if any(st != enc_want(k, img_of[k]) for k, st in zip(ckeys, got)):
                raise AssertionError("encode_corpus differs from encode_image")
            print(f"time encode_corpus {len(ckeys)} images, {enc_mpix:.2f} "
                  f"MPix, {workers} emission threads of "
                  f"{host} host cores: {wall:.3f} s, {enc_mpix / wall:.2f} "
                  f"MPix/s, {len(ckeys) / wall:.2f} images/s; host dispatch "
                  f"{spent.get('dispatch', 0):.3f} s, waiting on the card "
                  f"{spent.get('wait', 0):.3f} s, emission "
                  f"{spent.get('emit', 0):.3f} s "
                  f"({spent.get('emit', 0) / wall:.1%} of the wall) [{card}]")
    finally:
        (ebatch._dispatch_batch, ebatch._emit_from_unpacked,
         ebatch._InFlight.wait) = orig

    # the RGBA sprite sheet's encode_image: device scoring of its RGB planes
    # (queued), the host's alpha chunks, emission and zstd, and the wall
    sheet = enc_src["sheet2048"]
    sheet_planes = planes_of(sheet[..., :3], dev)

    def score_sheet():
        claims = torch.zeros(sheet_planes.shape, dtype=torch.bool,
                             device=dev)
        scoring.gradient_all(sheet_planes, claims, 3)
        pipeline.tile3d_all(sheet_planes, claims, tabs)
    for _ in range(2):
        ms = cuda_ms(score_sheet, 1)
        accepts, t3 = api.score_image(sheet, bank3d, "cuda")
        t = time.perf_counter()
        api.emit_image(sheet, accepts, t3)
        emit_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        yaik_tpu_torch.encode_image(sheet, bank3d, device="cuda")
        wall_ms = (time.perf_counter() - t) * 1e3
        print(f"time encode sheet2048 2048x2048 RGBA: scoring device "
              f"{ms:.3f} ms, host alpha + emission + zstd {emit_ms:.2f} ms, "
              f"encode_image wall {wall_ms:.2f} ms (host "
              f"{emit_ms / wall_ms:.1%} of it) [{card}]")
    del sheet_planes

    # the coverage kernels at corpus scale (phase 2e's operands), with the
    # bound of the distances the data needs: 3D every pixel against every
    # point, 9 int32 operations each (3 sub, 3 mul, 2 add, 1 min); 2D the
    # live points of each candidate against the counted pixels of each
    # tile, in the arithmetic the kernel takes for these u8 points: one
    # dp2a (2 multiply-adds) and a min, 5 operations at the CUDA cores'
    # peak (the float32 one; no dp2a rate is published), with the int32
    # bound (2 sub, 2 mul, 1 add, 1 min at the int32 rate) beside it
    for name, a in cover_args.items():
        fn = getattr(kernels, name)
        plain = getattr(kernels, f"{name}_plain")
        p1 = cuda_ms(lambda: plain(*a), 1, queued=False, warm=False)
        k1 = cuda_ms(lambda: fn(*a), 10)
        k2 = cuda_ms(lambda: fn(*a), 10)
        p2 = cuda_ms(lambda: plain(*a), 1, queued=False, warm=False)
        out = fn(*a)
        kms[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        if name == "covers":
            ops = {"i32": a[0].shape[0] * a[1].shape[0] * 64 * 64 * 9}
        else:
            dist = float(a[1].sum()) * float(a[3].sum())
            ops = {"f32": dist * 5, "i32": dist * 6}
        each = {kind: bound(list(a), [out], n_ops, kind)
                for kind, n_ops in ops.items()}
        # the share against the bound of the arithmetic the kernel runs;
        # the int32 bound of a kernel that runs none is stated bare
        bounds[name] = next(iter(each.values()))
        shares = "; ".join(
            f"{kind}-peak bound {b:.4f} ms ({by}, {ops[kind]:.4g} "
            "operations)" + (f", {b / kms[name][0]:.0%} of it" if i == 0
                             else "")
            for i, (kind, (b, by)) in enumerate(each.items()))
        print(f"time {name} k = {K_MINE}, n = {N_MINE}: kernel {k1:.4f} / "
              f"{k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms (plain, kernel, "
              f"kernel, plain); {shares}; launches per evaluation "
              f"{launches[name]} [{card}]")

    lap("end")
    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": kms[name][0], "plain_ms": kms[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         # no single PyTorch call computes any of these functions
         "library_ms": None,
         # the kernel's earlier design in the same turns, where one is kept
         "earlier_design_ms": earlier_ms.get(name)}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
