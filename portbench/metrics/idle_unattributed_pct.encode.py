"""The card's idle time that no span of the port accounts for, %: 100 x
the idle time of the traced window (no kernel, memcpy or memset running)
in which the calling thread was in no span of `yaik_tpu_torch`'s profiler,
over all idle time. Near 0, the program's spans say where every idle
stretch went."""
from portbench.harness import program

program.watch()


def read(run):
    return program.idle_unattributed_pct(run)
