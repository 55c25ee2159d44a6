"""The zstd-18 flush, ms per MPix encoded: the port's stage timers
`encode:zstd-flush` (`encode_image`) and `emit:zstd-flush`
(`encode_corpus`), summed over the window."""
from portbench.harness import readers


def read(run):
    s = readers.stage_s(run, ("encode:zstd-flush", "emit:zstd-flush"))
    return None if s is None else readers.per_mpix(run, s * 1e3)
