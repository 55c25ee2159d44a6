"""The device's idle share of the traced window, %: 100 x (1 - the union
of every kernel, memcpy and memset interval over the window)."""
from portbench.harness import readers


def read(run):
    return readers.idle_pct(run)
