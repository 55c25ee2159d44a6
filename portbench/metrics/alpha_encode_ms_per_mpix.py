"""The alpha stage of an RGBA encode, ms per MPix encoded: the port's stage
timer `encode:alpha` (`encoder.api._alpha_chunks`: the MIPM tile
rejection and the ALPM payload with its zstd level sweep, on the calling
thread), summed over the window. None where no span of that name was
recorded (an RGB cell, or a port without it)."""
from portbench.harness import readers


def read(run):
    s = readers.stage_s(run, ("encode:alpha",))
    return None if s is None else readers.per_mpix(run, s * 1e3)
