"""Bytes copied from card to host, MB per MPix answered: the port's
counter `d2h_bytes` (every copy through `decoder.engine.to_host`) over the
traced window."""
from portbench.harness import program, readers

program.watch()


def read(run):
    n = program.counter(run, "d2h_bytes")
    return None if n is None else readers.per_mpix(run, n / 1e6)
