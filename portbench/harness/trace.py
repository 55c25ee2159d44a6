"""What a traced run (`--trace 1`) records, and the arithmetic on it.

- Host spans: the benchmark's own, installed at run time around the port's
  functions that cross a layer (`SPANS`), as (label, start ns, end ns) on
  `time.time_ns()`, the clock the profiler's events are stamped with.
- Kernel calls: the operand shapes of each call of a hand kernel's wrapper
  that some metric reads (`record_calls`); shapes only, no device sync.
- Device events: every CUDA kernel, memcpy and memset that
  `torch.profiler` (CUDA activity alone) saw in the window.
- The port's stage timers (`utils/profiler.py`), summed by stage name.
"""
from __future__ import annotations

import contextlib
import importlib
import time

# (module, attribute, label): the layer boundaries a span is put around.
# A dotted attribute is a method of a class in that module.
SPANS = (
    ("yaik_tpu_torch.decoder.planner", "build_plan", "plan"),
    ("yaik_tpu_torch.decoder.pack", "plan_to_args", "pack"),
    ("yaik_tpu_torch.decoder.engine", "upload", "upload"),
    ("yaik_tpu_torch.decoder.engine", "decode_core", "decode_dispatch"),
    ("yaik_tpu_torch.parallel.batch", "_drain", "decode_drain"),
    ("yaik_tpu_torch.encoder.api", "score_image", "score"),
    ("yaik_tpu_torch.encoder.api", "emit_image", "emit"),
    ("yaik_tpu_torch.encoder.batch", "_dispatch_batch", "encode_dispatch"),
    ("yaik_tpu_torch.encoder.batch", "_InFlight.wait", "encode_drain"),
    ("yaik_tpu_torch.encoder.context", "_ZstdBatch.run", "zstd"),
)


def _owner(module: str, attr: str):
    obj = importlib.import_module(module)
    *path, name = attr.split(".")
    for p in path:
        obj = getattr(obj, p)
    return obj, name


def install_spans(spans: list) -> None:
    """Wrap each of `SPANS` so that a call appends (label, start ns, end
    ns) to `spans`."""
    for module, attr, label in SPANS:
        owner, name = _owner(module, attr)
        fn = getattr(owner, name)

        def wrapped(*a, __fn=fn, __label=label, **k):
            t0 = time.time_ns()
            try:
                return __fn(*a, **k)
            finally:
                spans.append((__label, t0, time.time_ns()))
        setattr(owner, name, wrapped)


def _shape(x):
    import torch
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.element_size())
    if isinstance(x, (tuple, list)):
        return [_shape(y) for y in x]
    return x if isinstance(x, (int, float, bool)) else None


def record_calls(names, calls: dict) -> None:
    """Wrap `ops.kernels.<name>` for each name so that every call appends
    {"args": shapes of its arguments, "out": shape of its result} to
    `calls[name]`. The wrapper keeps the launch counters the port's
    wrapper updates through its module name."""
    from yaik_tpu_torch.ops import kernels
    for name in names:
        fn = getattr(kernels, name)

        def wrapped(*a, __fn=fn, __name=name, **k):
            out = __fn(*a, **k)
            calls.setdefault(__name, []).append(
                {"args": [_shape(x) for x in a], "out": _shape(out)})
            return out
        wrapped.launches = fn.launches
        wrapped.per_device = fn.per_device
        setattr(kernels, name, wrapped)


@contextlib.contextmanager
def device_profile(out: list, on_card: bool):
    """Record the block's device events into `out` as (name, start ns, end
    ns, kind), kind "kernel", "memcpy" or "memset". On the CPU (tests) it
    records nothing."""
    if not on_card:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield
    out.extend(_device_events(prof))


def _device_events(prof) -> list:
    out = []
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA"):
            continue
        name, t0, t1 = e.name(), e.start_ns(), e.end_ns()
        low = name.lower()
        kind = ("memcpy" if low.startswith("memcpy") else
                "memset" if low.startswith("memset") else "kernel")
        out.append((name, int(t0), int(t1), kind))
    return out


def stage_totals(profile) -> dict:
    """Seconds per stage name, summed over the whole stage tree."""
    totals: dict = {}

    def walk(node):
        for ch in node.children.values():
            totals[ch.name] = totals.get(ch.name, 0.0) + ch.total
            walk(ch)
    if profile is not None:
        walk(profile.root)
    return totals


def union_ns(intervals, lo: int, hi: int) -> int:
    """Length of the union of [start, end) intervals, clipped to [lo, hi)."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps_ns(intervals, lo: int, hi: int) -> list:
    """The [start, end) stretches of [lo, hi) that no interval covers."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [(s, e) for s, e in gaps if e > s]


def host_timeline(spans: list, lo: int, hi: int) -> list:
    """[lo, hi) cut into (start, end, label) pieces, each labelled by the
    innermost span the host was in there (the latest begun of those open),
    or "unspanned" where none was (the loop between calls, the port's code
    outside the spans)."""
    spans = [sp for sp in spans if sp[2] > sp[1]]
    marks = sorted([(s, 1, k) for k, (_, s, _) in enumerate(spans)]
                   + [(e, 0, k) for k, (_, _, e) in enumerate(spans)])
    out, open_, t = [], [], lo
    for when, begins, k in marks:
        when = min(max(when, lo), hi)
        if when > t:
            out.append((t, when, spans[open_[-1]][0] if open_ else
                        "unspanned"))
            t = when
        if begins:
            open_.append(k)
        else:
            open_.remove(k)
    if t < hi:
        out.append((t, hi, spans[open_[-1]][0] if open_ else "unspanned"))
    return out


def idle_by_label(intervals, spans: list, lo: int, hi: int) -> dict:
    """Seconds of [lo, hi) that no device interval covers, summed by the
    host span they fell in (`host_timeline`)."""
    gaps = gaps_ns(intervals, lo, hi)
    out: dict = {}
    g = 0
    for s, e, label in host_timeline(spans, lo, hi):
        while g < len(gaps) and gaps[g][1] <= s:
            g += 1
        k = g
        while k < len(gaps) and gaps[k][0] < e:
            part = min(e, gaps[k][1]) - max(s, gaps[k][0])
            out[label] = out.get(label, 0.0) + part / 1e9
            k += 1
    return out


def nearest_rank(values, q: float) -> float:
    """The q-quantile by nearest rank: the smallest value with at least
    q of all values at or below it."""
    import math
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]
