#!/usr/bin/env python3
"""The gradient-stage kernel (`kernels.grad_score`) on the card at the
main path's operands, the 3840x2160 image (bench_4k decoded on the card),
zeroed claims each call and reject factor 3; held to its plain version bit
for bit, then timed. With `--parent`, beside another checkout's
csrc/grad_score.cu (the same C interface, `yaik_grad_score(planes, claims,
accepts, B, h, w, G, rf, stream)`), built alone with nvcc and held to the
plain version too, in turns (parent, this, this, parent):

    python3 tests/torch_time_grad_score.py [--parent PATH/grad_score.cu]

Prints the card's name and power limit, ptxas's registers and spills of
each build, each kernel's mean ms over 20 queued launches per turn, and the
bound: the planes read once, the claims read and written, the accepts
written, against 12 int32 operations per (pixel, channel, pass) (per blend
variant the numerator's step, the add of the pixel's term, a min and a
max; see the source's header note). `tests/grad_score_cta.cu` is the kernel's earlier
design, kept so that chip_smoke.py times it beside the kernel (`--parent
tests/grad_score_cta.cu` does so here).
"""
import argparse
import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from torch_time_covers import cuda_ms  # noqa: E402
from yaik_tpu_torch.format import swizzle  # noqa: E402
from yaik_tpu_torch.ops import build, kernels  # noqa: E402

FIX = ROOT / "tests" / "fixtures"
EARLIER = ROOT / "tests" / "grad_score_cta.cu"
RF = 3
OPS_PER_PIXEL_PASS = 3 * 12          # 3 channels x 12 int32 operations
PEAK_I32, HBM_BPS = 33.5e12, 3.35e12  # H100 SXM data sheet, dense


def ptxas_lines(log: str, symbol: str = "grad_score") -> list[str]:
    """ptxas's register and spill lines of the kernels named `symbol`."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = symbol in line
        elif keep and ("registers" in line or "spill" in line):
            lines.append(line.strip())
    return lines


def alone_library(src: pathlib.Path, name: str) -> tuple:
    """Builds `src` alone with the port's nvcc flags into a library of its
    own: (the ctypes library with `yaik_grad_score` bound, ptxas's
    lines)."""
    out = build.BUILD_DIR / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                           "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.yaik_grad_score.argtypes = build.SIGNATURES["yaik_grad_score"]
    lib.yaik_grad_score.restype = ctypes.c_int
    return lib, ptxas_lines(proc.stdout + proc.stderr)


def alone_call(lib, planes: torch.Tensor, claims: torch.Tensor,
               rf: int) -> torch.Tensor:
    """One launch of another build's kernel: [3, h, w] planes, claims
    updated in place -> [G] u8 accepts."""
    h, w = planes.shape[-2:]
    out = torch.empty(kernels.grad_score_len(h, w), dtype=torch.uint8,
                      device=planes.device)
    err = lib.yaik_grad_score(planes.data_ptr(), claims.data_ptr(),
                              out.data_ptr(), 1, h, w, out.numel(), rf,
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"yaik_grad_score: CUDA error {err}")
    return out


def bound_ms(planes: torch.Tensor) -> tuple:
    """(the least ms, what binds it, operations, bytes) of the stage on
    these planes: each pass covers its grid's pixels."""
    h, w = planes.shape[-2:]
    px_passes = sum(((h >> sy) << sy) * ((w >> sx) << sx)
                    for (sx, sy) in swizzle.GRADIENT_PASS_ORDER)
    ops = px_passes * OPS_PER_PIXEL_PASS
    moved = (planes.numel() * 4 + 2 * planes.numel()
             + kernels.grad_score_len(h, w))
    t_ops, t_bytes = ops / PEAK_I32 * 1e3, moved / HBM_BPS * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", ops, moved)


def on_fresh_claims(fn, planes: torch.Tensor, n: int):
    """A call of fn(planes, claims, RF) on a zeroed claims tensor of its own
    each time (the main path's operands), n calls at most."""
    pool = iter([torch.zeros(planes.shape, dtype=torch.bool,
                             device=planes.device) for _ in range(n)])
    return lambda: fn(planes, next(pool), RF)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_time_grad_score: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import yaik_tpu_torch
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    _, log = build.build()
    build.library()
    for line in ptxas_lines(log):
        print(f"this: ptxas {line}")
    lib = None
    if args.parent:
        lib, lines = alone_library(args.parent, "parent_grad_score")
        for line in lines:
            print(f"parent: ptxas {line}")
    bank = yaik_tpu_torch.assign_lut((FIX / "LutFile.lut").read_bytes())
    img = yaik_tpu_torch.decode_image((FIX / "bench_4k.yaik").read_bytes(),
                                      bank, device="cuda")
    planes = torch.from_numpy(np.ascontiguousarray(
        img[:, :, :3].transpose(2, 0, 1), np.int32)).to(dev)
    calls = {"this": kernels.grad_score}
    if lib is not None:
        calls["parent"] = lambda p, c, rf: alone_call(lib, p, c, rf)
    zeros = torch.zeros(planes.shape, dtype=torch.bool, device=dev)
    want_claims = zeros.clone()
    want = kernels.grad_score_plain(planes, want_claims, RF)
    for who, fn in calls.items():
        claims = zeros.clone()
        got = fn(planes, claims, RF)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(claims, want_claims)):
            raise AssertionError(f"{who} grad_score differs from the plain "
                                 "version")
    turns = []
    for who in ("parent", "this", "this", "parent"):
        if who in calls:
            turns.append((who, cuda_ms(on_fresh_claims(calls[who], planes,
                                                       23))))
    b, by, ops, moved = bound_ms(planes)
    best = min(ms for who, ms in turns if who == "this")
    line = ", ".join(f"{who} {ms:.4f}" for who, ms in turns)
    print(f"time grad_score 3840x2160, reject factor {RF}: {line} ms; "
          f"bound {b:.4f} ms ({by}: {ops:.4g} int32 operations, "
          f"{moved / 1e6:.1f} MB), {b / best:.0%} of it; "
          f"{int(want.sum())} of {want.numel()} tiles accepted [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
