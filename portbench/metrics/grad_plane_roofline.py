"""`grad_plane` (the split decode's gradient plane, `ops/csrc/grad_plane.cu`,
kernel `grad_plane_kernel<false>`): its share of the card's roofline, %.

The frozen count of PERF.md's kernel table (chip_smoke's): each call reads
its corners and code4 once and writes its int32 plane once, and does 40
int32 operations per output pixel; the bound is the larger of bytes over
HBM bandwidth and operations over the int32 peak (`harness.peaks`)."""
from portbench.harness import readers

RECORDS = ("grad_plane",)
KERNEL = "grad_plane_kernel<false>"
OPS_PER_PIXEL = 40


def count(call):
    corners, code4 = call["args"][:2]
    out = call["out"]
    moved = readers.nbytes(corners) + readers.nbytes(code4) + \
        readers.nbytes(out)
    return moved, readers.nbytes(out) // out[1] * OPS_PER_PIXEL, "i32"


def read(run):
    return readers.roofline(run, "grad_plane", KERNEL, count)
