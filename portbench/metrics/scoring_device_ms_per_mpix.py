"""Device scoring, ms per MPix encoded: the summed durations of every
kernel in the traced window (hand kernels and torch ops alike)."""
from portbench.harness import readers


def read(run):
    ks = readers.kernels(run)
    if not ks:
        return None
    return readers.per_mpix(run, sum(e - s for _, s, e in ks) / 1e6)
