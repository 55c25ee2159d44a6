"""Host plan + pack, ms per request: the benchmark's spans around
`decoder.planner.build_plan` and `decoder.pack.plan_to_args`, summed over
the window, over the requests answered."""
from portbench.harness import readers


def read(run):
    s = readers.span_s(run, {"plan", "pack"})
    if s is None or not run.items_done:
        return None
    return s * 1e3 / run.items_done
