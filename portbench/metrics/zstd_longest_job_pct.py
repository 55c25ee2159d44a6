"""How far the longest stream sets the zstd-18 flush, %: summed over the
traced window's flushes (the spans that hold the port's `zstd:job` spans,
`encode:zstd-flush` in `encode_image`), each flush's longest job, over the
flushes' summed durations. Near 100, one stream sets the flush; near
100 / jobs, the pool is full."""
from portbench.harness import program

program.watch()


def read(run):
    return program.longest_child_pct(run, "zstd:job")
