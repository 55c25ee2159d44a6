"""Bytes copied from host to card, MB per MPix answered: the port's
counter `h2d_bytes` (every copy through `decoder.engine.to_card`) over the
traced window."""
from portbench.harness import program, readers

program.watch()


def read(run):
    n = program.counter(run, "h2d_bytes")
    return None if n is None else readers.per_mpix(run, n / 1e6)
