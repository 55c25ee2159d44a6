"""Host packing of decode operands, ms per MPix decoded: the port's span
`decode:pack` (`decoder.pack.plan_to_args`: the gradient, T3, 2DTL, 1D
and overlay / plane-gradient / alpha operands), summed over the traced
window."""
from portbench.harness import program, readers

program.watch()


def read(run):
    s = program.span_s(run, "decode:pack")
    return None if s is None else readers.per_mpix(run, s * 1e3)
