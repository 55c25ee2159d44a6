"""`grad_score` (the encoder's gradient stage, `ops/csrc/grad_score.cu`,
kernel `grad_score_kernel`): its share of the card's roofline, %.

The frozen count of PERF.md's kernel table (chip_smoke's and
`tests/torch_time_grad_score.py`'s): 12 int32 operations per pixel, channel
and pass over each pass's whole tiles; the int32 planes read once, the
claims read and written once, the packed accepts written once. The bound is
the larger of bytes over HBM bandwidth and operations over the int32 peak
(`harness.peaks`). `score48_mode` and `values48`, the other two encode
kernels, do work that depends on which pixels are alive, which a count from
shapes alone cannot give, so they have no roofline here."""
from portbench.harness import readers

RECORDS = ("grad_score",)
KERNEL = "grad_score_kernel"
OPS_PER_PIXEL_PASS = 3 * 12
# (log2 tile width, log2 tile height): 16x16, 16x8, 8x16, 8x8, 8x4, 4x8, 4x4
PASSES = ((4, 4), (4, 3), (3, 4), (3, 3), (3, 2), (2, 3), (2, 2))


def count(call):
    planes, claims = call["args"][:2]
    out = call["out"]
    *lead, _, h, w = planes[0]
    images = 1
    for d in lead:
        images *= d
    px = sum(((h >> sy) << sy) * ((w >> sx) << sx) for sx, sy in PASSES)
    moved = readers.nbytes(planes) + 2 * readers.nbytes(claims) + \
        readers.nbytes(out)
    return moved, images * px * OPS_PER_PIXEL_PASS, "i32"


def read(run):
    return readers.roofline(run, "grad_score", KERNEL, count)
