"""Host plan + pack (`decoder.planner.build_plan`, `decoder.pack.
plan_to_args`), ms per MPix decoded: the benchmark's own spans around the
two functions, summed over the window."""
from portbench.harness import readers


def read(run):
    s = readers.span_s(run, {"plan", "pack"})
    return None if s is None else readers.per_mpix(run, s * 1e3)
