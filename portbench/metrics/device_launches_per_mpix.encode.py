"""Device kernels launched per MPix encoded: every kernel event in the
traced window, hand kernels and torch ops."""
from portbench.harness import readers


def read(run):
    ks = readers.kernels(run)
    return readers.per_mpix(run, float(len(ks))) if ks else None
