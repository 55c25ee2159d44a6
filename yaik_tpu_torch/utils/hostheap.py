"""The host heap's policy for on-demand decodes.

glibc adapts its thresholds as a process runs: a freed block that was
mapped on its own raises the mmap threshold to its size, and the trim
threshold to twice that, and the heap's free top is handed back to the
kernel whenever it grows past the trim threshold. A 2048x2048 decode
allocates and frees some 100 MB of host buffers a call (the plan, the
packed operands, the download), so depending on what the process freed
before, those buffers are either reused or unmapped and faulted in again,
page by page, on the next call: on an H100's host the same pages decoded at
a p95 of 152-174 ms with glibc's defaults and 106-125 ms with the heap
held.

`hold()` sets both thresholds once per process, which also ends the
adaptation: blocks under `MMAP_THRESHOLD` come from the heap, and up to
`TRIM_THRESHOLD` bytes free at its top stay mapped. It does nothing where
the C library has no `mallopt` (not glibc), or where the environment sets
glibc's own malloc variables, which then decide."""
from __future__ import annotations

import ctypes
import functools
import os

M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3     # glibc's malloc.h
MMAP_THRESHOLD = 32 << 20     # the largest glibc accepts on a 64-bit host
TRIM_THRESHOLD = 512 << 20
ENV = ("MALLOC_MMAP_THRESHOLD_", "MALLOC_TRIM_THRESHOLD_", "MALLOC_MMAP_MAX_",
       "MALLOC_TOP_PAD_")


@functools.cache
def hold() -> bool:
    """Fix the heap's thresholds; True where both were set."""
    if any(k in os.environ for k in ENV) or \
            "glibc.malloc." in os.environ.get("GLIBC_TUNABLES", ""):
        return False
    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (OSError, AttributeError):
        return False
    mallopt.argtypes, mallopt.restype = (ctypes.c_int, ctypes.c_int), \
        ctypes.c_int
    return bool(mallopt(M_MMAP_THRESHOLD, MMAP_THRESHOLD)) and \
        bool(mallopt(M_TRIM_THRESHOLD, TRIM_THRESHOLD))
