"""The fixed cost of one `decode_corpus` batch, ms: the port's per-batch
spans `decode:stack` (the operands stacked), `decode:upload`,
`decode:dispatch` (the kernels queued) and `decode:drain` (the download
and the host alpha), their union over the traced window (a span inside
another counts once), over the port's counter `decode_batches`. None where
the port counted no batch (a port without the counter)."""
from portbench.harness import program, trace

program.watch()

SPANS = ("decode:stack", "decode:upload", "decode:dispatch", "decode:drain")


def read(run):
    p = program.profile(run)
    if p is None or not p.counters.get("decode_batches"):
        return None
    lo, hi = run.window_ns
    held = trace.union_ns([(e.start_ns, e.end_ns) for e in p.events
                           if e.name in SPANS], lo, hi)
    return held / 1e6 / p.counters["decode_batches"]
