"""The alpha work of an RGBA decode, ms per MPix decoded: the port's spans
`plan:mipm` and `plan:alpm` (the planner's MIPM bits and ALPM zstd
decompression), `pack:alpha` (the alpha operands) and `decode:alpha` (the
host's launch of the alpha-plane join on the card; the card's own time is
in the device trace), summed over the traced window. None where no such
span was recorded (an RGB cell, or a port without them)."""
from portbench.harness import program, readers

program.watch()

SPANS = ("plan:mipm", "plan:alpm", "pack:alpha", "decode:alpha")


def read(run):
    got = [s for s in (program.span_s(run, n) for n in SPANS)
           if s is not None]
    return readers.per_mpix(run, sum(got) * 1e3) if got else None
