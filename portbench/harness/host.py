"""Readings of the host over the measured window, printed beside the result
(`host` in the result line), so that a run whose host was slow can be told
from one whose program did more: the calling thread's and the whole
process's CPU time. The same work taking more CPU time on the calling
thread is a slower core. (The card's machine reports no load, steal time or
clock of its host in `/proc`, so those are not read.)"""
from __future__ import annotations

import resource
import time


def snapshot() -> dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"wall": time.perf_counter(), "thread": time.thread_time(),
            "proc": ru.ru_utime + ru.ru_stime}


def delta(a: dict, b: dict) -> dict:
    """Seconds of wall, of the calling thread's CPU and of the process's
    CPU between two snapshots."""
    return {"wall_s": b["wall"] - a["wall"],
            "main_cpu_s": b["thread"] - a["thread"],
            "proc_cpu_s": b["proc"] - a["proc"]}
