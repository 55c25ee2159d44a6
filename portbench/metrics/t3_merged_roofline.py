"""`t3_merged` (the split decode's merged T3 resolve, `ops/csrc/t3_merged.cu`,
kernel `merged_kernel<0>`): its share of the card's roofline, %.

The frozen count of PERF.md's kernel table (chip_smoke's): each call reads
every tensor operand once (table, idx16, cols, accept, rows) and writes its
int32 [.., G, 16] values once, and does 40 int32 operations per value; the
bound is the larger of bytes over HBM bandwidth and operations over the
int32 peak (`harness.peaks`)."""
from portbench.harness import readers

RECORDS = ("t3_merged",)
KERNEL = "merged_kernel<0>"
OPS_PER_VALUE = 40


def count(call):
    tensors = [a for a in call["args"] if isinstance(a, tuple)]
    out = call["out"]
    moved = sum(readers.nbytes(t) for t in tensors) + readers.nbytes(out)
    return moved, readers.nbytes(out) // out[1] * OPS_PER_VALUE, "i32"


def read(run):
    return readers.roofline(run, "t3_merged", KERNEL, count)
