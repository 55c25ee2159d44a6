#!/usr/bin/env python3
"""The coverage kernels (`kernels.covers`, `kernels.covers2d`) on the card
at chip_smoke's phase 2e operands (`torch_covers.corpus`: k = 256
candidate clouds against n = 50,000 seeded clouds), each held to its plain version bit for bit,
then timed; with `--parent`, beside another checkout's csrc/covers.cu
whose C interface is the shared 2D/3D one
(`yaik_covers(cands, cmask, tiles, tmask, D, k, n, gate, out, stream)`),
built alone with nvcc, in turns (parent, this, this, parent):

    python3 tests/torch_time_covers.py [--parent PATH/covers.cu]

Prints the card's name and power limit, the operands' live-point and
counted-pixel shares, and for each kernel its mean ms over 20 queued
launches per turn and its bounds, and the 2D batch plan
(`kernels.covers2d_plan`) alone. A bound counts the needed distances (3D
every pixel against every point; 2D live points x counted pixels) at 9
int32 operations (3D), at 6 int32 operations and at 5 operations (2D:
one dp2a, two multiply-adds, and a min) at the CUDA cores' float32 peak
(no dp2a rate is published) a distance.
"""
import argparse
import ctypes
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import torch_covers  # noqa: E402
from yaik_tpu_torch.ops import build, kernels  # noqa: E402

K, N = 256, 50_000
PEAK = {"i32": 33.5e12, "f32": 67e12}    # H100 SXM data sheet, dense




def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device ms a call over `iters` calls queued behind a device
    sleep (so the events time the card's work, not the host's dispatch)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * iters * host_s * 2e9) + 1000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def parent_library(src: pathlib.Path) -> ctypes.CDLL:
    out = build.BUILD_DIR / "parent_covers.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.ARCH, "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-o", str(out),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.yaik_covers.argtypes = [P, P, P, P, I, I, I, I, P, P]
    lib.yaik_covers.restype = I
    return lib


def parent_call(lib, name, a):
    """The parent's wrapper: int32 contiguous operands, one launch."""
    D = 3 if name == "covers" else 2
    c = a[0].to(torch.int32).contiguous()
    t = a[-2 if D == 2 else 1].to(torch.int32).contiguous()
    cm = a[1].data_ptr() if D == 2 else None
    tm = a[3].data_ptr() if D == 2 else None
    out = torch.empty((c.shape[0], t.shape[0]), dtype=torch.bool,
                      device=c.device)
    err = lib.yaik_covers(c.data_ptr(), cm, t.data_ptr(), tm, D,
                          c.shape[0], t.shape[0], 75 if D == 3 else 36,
                          out.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent yaik_covers: CUDA error {err}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_time_covers: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    ops = {name: tuple(torch.from_numpy(a).to(dev) for a in arrs)
           for name, arrs in torch_covers.corpus(K, N).items()}
    lib = parent_library(args.parent) if args.parent else None
    live, counted = ops["covers2d"][1], ops["covers2d"][3]
    print(f"covers2d operands: live-point share "
          f"{float(live.float().mean()):.4f}, counted-pixel share "
          f"{float(counted.float().mean()):.4f}")
    for name, a in ops.items():
        fn = getattr(kernels, name)
        want = getattr(kernels, f"{name}_plain")(*a)
        got = {"this": fn(*a)}
        if lib:
            got["parent"] = parent_call(lib, name, a)
        for who, g in got.items():
            if not torch.equal(g, want):
                raise AssertionError(f"{who} {name} differs from the plain "
                                     "version")
        if name == "covers":
            dist = K * N * 64 * 64
            bounds = {"i32": dist * 9 / PEAK["i32"] * 1e3}
        else:
            dist = float(live.sum()) * float(counted.sum())
            bounds = {"f32": dist * 5 / PEAK["f32"] * 1e3,
                      "i32": dist * 6 / PEAK["i32"] * 1e3}
        turns = []
        for who in ("parent", "this", "this", "parent"):
            if who == "parent" and lib is None:
                continue
            call = ((lambda: fn(*a)) if who == "this" else
                    (lambda: parent_call(lib, name, a)))
            turns.append((who, cuda_ms(call)))
        line = ", ".join(f"{who} {ms:.4f}" for who, ms in turns)
        best = min(ms for who, ms in turns if who == "this")
        # the share against the bound of the arithmetic the kernel runs
        # (the first); the int32 bound of the 2D kernel is stated bare
        share = ", ".join(
            f"{kind}-peak bound {b:.4f} ms" + (f" ({b / best:.0%} of it)"
                                               if i == 0 else "")
            for i, (kind, b) in enumerate(bounds.items()))
        print(f"time {name} k = {K}, n = {N} ({dist:.4g} needed distances):"
              f" {line} ms; {share} [{card}]")
    tmask = ops["covers2d"][3]
    print(f"time covers2d_plan: "
          f"{cuda_ms(lambda: kernels.covers2d_plan(tmask)):.4f} ms [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
