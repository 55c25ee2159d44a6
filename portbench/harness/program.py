"""The port's own spans and counters in a traced run (`--trace 1`), and the
arithmetic the metrics that read them share.

The port records them itself (`yaik_tpu_torch/utils/profiler.py`): each
span with its name, call id, span id, parent span id, thread and start and
end ns on the clock of the device events, and counters (the bytes and
copies between host and card, the zstd jobs' bytes). A traced run opens one
profile around its window (`profiler.enable()` in `bench.run_cell`).
`watch()`, which each reader of these metrics calls when it is loaded
(before the window), keeps that profile; the functions here read it. Where
the profile holds no spans (a port that records none), they return None,
and the metrics are left out of the result line.
"""
from __future__ import annotations

import contextlib
import threading

from portbench.harness import trace

_KEPT: list = []          # the last profile the port's enable() opened


def watch() -> None:
    """Keep each profile that the port's `profiler.enable()` opens from
    now on (the last one, for `profile`). Wraps `enable` once a process."""
    from yaik_tpu_torch.utils import profiler
    if getattr(profiler.enable, "portbench_watch", False):
        return
    opened = profiler.enable

    @contextlib.contextmanager
    def enable(*a, **k):
        with opened(*a, **k) as prof:
            _KEPT[:] = [prof]
            yield prof
    enable.portbench_watch = True
    profiler.enable = enable


def profile(run):
    """The profile of the run's traced window, with its spans (`events`)
    and counters; None where the run was not traced or the profile kept
    holds no spans."""
    if not run.traced or not _KEPT:
        return None
    p = _KEPT[-1]
    lo, hi = run.window_ns
    if getattr(p, "events", None) is None or p.t1 is None or \
            not p.t0 <= lo <= hi <= p.t1:
        return None
    return p


def span_s(run, name: str) -> float | None:
    """Seconds summed over the spans named `name` (None when none was
    recorded)."""
    p = profile(run)
    got = [e.end_ns - e.start_ns for e in p.events if e.name == name] \
        if p else []
    return sum(got) / 1e9 if got else None


def counter(run, name: str) -> int | None:
    """A counter's total over the window (0 when nothing was counted under
    it; None without the port's spans)."""
    p = profile(run)
    return None if p is None else p.counters.get(name, 0)


def idle_by_program_span(run) -> dict | None:
    """Seconds of the window in which the card was idle, summed by the
    innermost span that the calling thread (the one that runs the loop and
    reads the metrics) was in, "unspanned" where it was in none."""
    p = profile(run)
    if p is None:
        return None
    me = threading.get_ident()
    spans = [(e.name, e.start_ns, e.end_ns) for e in p.events
             if e.thread == me]
    lo, hi = run.window_ns
    return trace.idle_by_label([(s, e) for _, s, e, _ in run.device_events],
                               spans, lo, hi)


def idle_unattributed_pct(run) -> float | None:
    """100 x the card's idle time in which the calling thread was in no
    span of the port, over all of the card's idle time."""
    idle = idle_by_program_span(run)
    if idle is None:
        return None
    total = sum(idle.values())
    return 100.0 * idle.get("unspanned", 0.0) / total if total else 0.0


def longest_child_pct(run, child: str) -> float | None:
    """100 x the sum over the spans that hold spans named `child` of their
    longest such child, over the sum of those spans' durations: near 100,
    one child sets each parent's time."""
    p = profile(run)
    if p is None:
        return None
    longest: dict = {}
    for e in p.events:
        if e.name == child:
            longest[e.parent] = max(longest.get(e.parent, 0),
                                    e.end_ns - e.start_ns)
    parents = [e for e in p.events if e.span in longest]
    held = sum(e.end_ns - e.start_ns for e in parents)
    if not held:
        return None
    return 100.0 * sum(longest[e.span] for e in parents) / held


def program_spans(run) -> dict | None:
    """{name: [self seconds, total seconds, count]} over the window's spans,
    self being a span's duration less the union of its children's."""
    p = profile(run)
    if p is None:
        return None
    out: dict = {}
    todo = list(p.root.children.values())
    while todo:
        node = todo.pop()
        got = out.setdefault(node.name, [0.0, 0.0, 0])
        got[0] += node.self_s
        got[1] += node.total
        got[2] += node.count
        todo.extend(node.children.values())
    return out
