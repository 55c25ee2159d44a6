"""zstd compressions an RGBA image's ALPM payload costs: the port's counter
`alpm_sweep_compressions` (each `zstd.compress` of the level sweep 5-21,
the final compression at the chosen level included) over the traced
window, over the images encoded. None where the port counted nothing under
that name."""
from portbench.harness import program

program.watch()


def read(run):
    p = program.profile(run)
    if p is None or "alpm_sweep_compressions" not in p.counters or \
            not run.items_done:
        return None
    return p.counters["alpm_sweep_compressions"] / run.items_done
