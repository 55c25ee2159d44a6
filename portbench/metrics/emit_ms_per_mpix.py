"""Host emission, ms per MPix encoded: the port's stage timers
`encode:gradient` (gradient emission), `encode:3d-emit`, `encode:3d-chunk`,
`encode:1d` and `emit:assemble`, summed over the window (single-threaded
paths: `encode_image`, `encode_corpus` with `emit_workers=0`)."""
from portbench.harness import readers

STAGES = ("encode:gradient", "encode:3d-emit", "encode:3d-chunk",
          "encode:1d", "emit:assemble")


def read(run):
    s = readers.stage_s(run, STAGES)
    return None if s is None else readers.per_mpix(run, s * 1e3)
