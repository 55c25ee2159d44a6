"""Helpers the metric readers share: pixels done, span and stage time,
device time, idle share and roofline shares over a run's window."""
from __future__ import annotations

from portbench.harness import peaks, trace


def mpix(run) -> float:
    """Megapixels answered by the calls that succeeded in the window, each
    item counted with its own pixels."""
    px = run.item_pixels
    return sum(px[i] for c in run.calls if c.ok for i in c.items) / 1e6


def per_mpix(run, value):
    m = mpix(run)
    return value / m if m and value is not None else None


def span_s(run, labels) -> float | None:
    """Seconds the window spent in the benchmark's spans of `labels`
    (None when no such span was recorded)."""
    got = [e - s for label, s, e in run.spans if label in labels]
    return sum(got) / 1e9 if got else None


def stage_s(run, names) -> float | None:
    """Seconds the port's stage timers recorded under `names`."""
    got = [run.stages[n] for n in names if n in run.stages]
    return sum(got) if got else None


def kernels(run, pattern: str = "") -> list:
    """(name, start ns, end ns) of the window's kernel events whose name
    holds `pattern`."""
    lo, hi = run.window_ns
    return [(n, s, e) for n, s, e, kind in run.device_events
            if kind == "kernel" and pattern in n and s < hi and e > lo]


def idle_pct(run) -> float | None:
    """100 x (1 - the union of kernel, memcpy and memset intervals over
    the traced window)."""
    if not run.device_events:
        return None
    lo, hi = run.window_ns
    busy = trace.union_ns([(s, e) for _, s, e, _ in run.device_events],
                          lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo))


def roofline(run, wrapper: str, kernel_name: str, count) -> float | None:
    """100 x the sum over the window's calls of `wrapper` of the card's
    least time for each (`count(call)` -> (bytes moved, operations,
    kind)), over the sum of the measured times of the kernel events named
    `kernel_name`. None when either side is missing."""
    calls = run.kernel_calls.get(wrapper)
    events = kernels(run, kernel_name)
    if not calls or not events:
        return None
    bound = sum(peaks.bound_s(*count(c)) for c in calls)
    measured = sum(e - s for _, s, e in events) / 1e9
    return 100.0 * bound / measured


def nbytes(shape) -> int:
    """Bytes of a recorded tensor shape, (dims, element size)."""
    dims, size = shape
    n = size
    for d in dims:
        n *= d
    return n
