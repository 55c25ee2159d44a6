"""decode_p95_ms (ms): the 95th percentile, by nearest rank, of every
request of the window: one call of the decode entry point, from the call to
the pixels on the host. A failed call counts as the longest."""
from portbench.harness import trace


def read(run):
    if run.kind != "decode" or not run.calls:
        return None
    lat = [(c.t1 - c.t0) if c.ok else float("inf") for c in run.calls]
    return 1e3 * trace.nearest_rank(lat, 0.95)
