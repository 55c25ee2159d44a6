"""Host spans and counters of the port, and device traces.

The stage names and the `--profile` report follow the JAX package's
`yaik_tpu/utils/profiler.py` (`decode:plan`, `encode:3d-scoring`, ...);
the recorder beneath them is the port's own:

- `stage(name)` records one span: name, call id, span id, parent span id,
  thread id, start and end ns. The stack of open spans is per thread. A
  span opened on a thread with no open span starts a new call (its call id
  is its own span id); spans nested under it share that call id. Work
  handed to another thread takes its parent along:
  `stage(name, parent=current())`, `current()` read on the submitting
  thread.
- `count(name, n)` adds to a counter (per thread while the profile runs,
  merged when it ends): the bytes and copies between host and card
  (`h2d_bytes`, `h2d_copies`, `d2h_bytes`, `d2h_copies`), the zstd jobs'
  bytes in and out.
- Every span is stamped by `now_ns()`, the clock of the `torch.profiler`
  device events (Unix-epoch ns), so spans and kernels share one timeline.

Usage:
    from yaik_tpu_torch.utils import profiler
    with profiler.enable() as prof:
        ... encode/decode calls (stages instrument themselves) ...
    print(profiler.report(prof))

    with profiler.stage("my-stage"):       # explicit stage
        ...

    with profiler.device_trace("/tmp/tb"):  # CUDA kernels -> Perfetto
        ...

Off (no profile enabled), `stage` and `count` make one check and return;
callers compute what they count only under `if profiler.on():`. Enabling
is process-global: a profile records the spans of every thread until its
block ends, and is meant for profiling and the benchmark's traced runs,
not production. A stage is host time: a device stage ends where its results
reach the host, so it holds the device work it waited for."""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

_active: "Profile | None" = None


def now_ns() -> int:
    """The spans' clock: Unix-epoch ns, the clock `torch.profiler` stamps
    the card's events with."""
    return time.time_ns()


class Span(NamedTuple):
    name: str
    call: int            # the span id of the call's root span
    span: int
    parent: int          # 0 for a call's root span
    thread: int          # threading.get_ident() of the thread it ran on
    start_ns: int
    end_ns: int


class _Node:
    """One line of the report: the spans of one name under one path."""
    __slots__ = ("name", "total", "self_s", "count", "children")

    def __init__(self, name):
        self.name = name
        self.total = 0.0
        self.self_s = 0.0
        self.count = 0
        self.children: dict = {}


class Profile:
    """The spans (`events`, in the order they ended) and counters
    (`counters`, after the block ends) recorded while enabled."""

    def __init__(self):
        self.events: list[Span] = []
        self.counters: dict = {}
        self.t0 = now_ns()
        self.t1: int | None = None
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._thread_counters: list = []

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _counters(self) -> dict:
        try:
            return self._local.counters
        except AttributeError:
            c = self._local.counters = {}
            self._thread_counters.append(c)
            return c

    def _close(self) -> None:
        self.t1 = now_ns()
        merged: dict = {}
        for c in self._thread_counters:
            for k, v in c.items():
                merged[k] = merged.get(k, 0) + v
        self.counters = merged

    @property
    def root(self) -> _Node:
        """The spans as a tree of names (a name's node per path of names
        from the call's root span), each node's total and self seconds and
        count summed over its spans; the root is the whole profile."""
        end = self.t1 if self.t1 is not None else now_ns()
        root = _Node("total")
        root.total, root.count = (end - self.t0) / 1e9, 1
        events = sorted(self.events, key=lambda e: e.start_ns)
        by_id = {e.span: e for e in events}
        kids: dict = {}
        for e in events:
            kids.setdefault(e.parent if e.parent in by_id else 0, []).append(e)
        root.self_s = (end - self.t0 - _covered(kids.get(0, ()), self.t0,
                                                end)) / 1e9
        todo = collections.deque((root, e) for e in kids.get(0, ()))
        while todo:
            parent, e = todo.popleft()
            node = parent.children.get(e.name)
            if node is None:
                node = parent.children[e.name] = _Node(e.name)
            ch = kids.get(e.span, ())
            node.total += (e.end_ns - e.start_ns) / 1e9
            node.self_s += (e.end_ns - e.start_ns
                            - _covered(ch, e.start_ns, e.end_ns)) / 1e9
            node.count += 1
            todo.extend((node, c) for c in ch)
        return root


def _covered(spans, lo: int, hi: int) -> int:
    """ns of [lo, hi) that the union of `spans` covers."""
    total, cur = 0, lo
    for s, e in sorted((max(x.start_ns, lo), min(x.end_ns, hi))
                       for x in spans):
        if e > cur:
            total += e - max(s, cur)
            cur = e
    return total


class _Stage:
    __slots__ = ("p", "name", "parent", "ids", "t0")

    def __init__(self, p: Profile, name: str, parent):
        self.p, self.name, self.parent = p, name, parent

    def __enter__(self):
        stack = self.p._stack()
        sid = next(self.p._ids)
        if self.parent is not None:
            call, parent = self.parent
        elif stack:
            call, parent = stack[-1]
        else:
            call, parent = sid, 0
        self.ids = (call, sid, parent)
        stack.append((call, sid))
        self.t0 = now_ns()

    def __exit__(self, *exc):
        t1 = now_ns()
        self.p._stack().pop()
        call, sid, parent = self.ids
        self.p.events.append(Span(self.name, call, sid, parent,
                                  threading.get_ident(), self.t0, t1))
        return False


_OFF = contextlib.nullcontext()


def stage(name: str, parent: tuple | None = None):
    """A span around one pipeline stage; a no-op when no profile is
    enabled. `parent` (from `current()` on another thread) places a span
    opened on a pool thread under the span that handed it the work."""
    p = _active
    if p is None:
        return _OFF
    return _Stage(p, name, parent)


def current() -> tuple | None:
    """(call id, span id) of this thread's innermost open span, to hand to
    `stage(..., parent=)` on the thread that takes over the work; None
    when no profile is enabled or no span is open."""
    p = _active
    if p is None:
        return None
    stack = p._stack()
    return stack[-1] if stack else None


def on() -> bool:
    """Whether a profile is recording."""
    return _active is not None


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` (a no-op when no profile is
    enabled)."""
    p = _active
    if p is None:
        return
    c = p._counters()
    c[name] = c.get(name, 0) + n


@contextlib.contextmanager
def enable():
    """Record spans and counters for the dynamic extent of the block;
    yields the `Profile`."""
    global _active
    prev, _active = _active, Profile()
    try:
        yield _active
    finally:
        _active._close()
        _active = prev


def report(profile: Profile | None = None) -> str:
    """The given (or the running) profile as an indented table, each name
    under the names it ran in, with its total, its self time (the total
    less what its child spans cover) and its count; then the counters."""
    p = profile or _active
    if p is None:
        return "(no profile captured)"
    root = p.root
    lines = []

    def walk(node, depth):
        pct = 100.0 * node.total / max(root.total, 1e-12)
        lines.append(f"{'  ' * depth}{node.name:<30} "
                     f"{node.total * 1e3:9.2f} ms {node.self_s * 1e3:9.2f} "
                     f"ms self  x{node.count:<5d} {pct:5.1f}%")
        for ch in node.children.values():
            walk(ch, depth + 1)

    walk(root, 0)
    if p.counters:                           # merged when the block ends
        lines += ["", "counters"]
        lines += [f"  {k:<28} {v:>14d}" for k, v in sorted(p.counters.items())]
    return "\n".join(lines)


def kernel_events(trace: dict) -> list:
    """The CUDA kernel events of a Chrome trace (category "kernel")."""
    return [e for e in trace.get("traceEvents", ())
            if e.get("cat") == "kernel"]


@contextlib.contextmanager
def device_trace(logdir: str, device="cuda"):
    """Record a `torch.profiler` trace of the block into
    `<logdir>/trace.json` (`export_chrome_trace`: Chrome trace JSON, which
    Perfetto, chrome://tracing and TensorBoard's trace viewer open). On a
    CUDA device it records the CPU and CUDA activities, on the CPU the CPU
    activity alone.

    Unlike the JAX package's wrapper, this one never falls back: CUDA asked
    for without a card raises (`decoder.engine.device_of`), and so does a
    CUDA trace that holds no kernel event (CUPTI did not start), before
    any file is written. Kernels queued in the block must have finished by
    its end (the port's entry points end in a download)."""
    from torch.profiler import ProfilerActivity, profile

    from yaik_tpu_torch.decoder.engine import device_of

    on_card = device_of(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    tmp = path + ".tmp"
    prof.export_chrome_trace(tmp)
    with open(tmp) as f:
        trace = json.load(f)
    if on_card and not kernel_events(trace):
        os.remove(tmp)
        raise RuntimeError("torch.profiler recorded no CUDA kernel event "
                           "(CUPTI tracing unavailable on this machine?)")
    os.replace(tmp, path)
